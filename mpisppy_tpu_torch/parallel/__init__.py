"""Scenario-axis sharding over torch.distributed ranks (the port of the
JAX package's parallel/): ``mesh`` holds the rank's view of the mesh and
the collective scenario operations, ``launch`` starts the ranks."""
