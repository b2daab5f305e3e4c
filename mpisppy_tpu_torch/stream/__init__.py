"""Scenario streaming: the chunked loop's per-scenario vector blocks
stop being device-resident (the port of mpisppy_tpu/stream).

A :class:`~mpisppy_tpu_torch.stream.source.ScenarioSource`
(``scenario_source`` engine option: ``resident`` | ``streamed`` |
``synthesized``) stages them per chunk instead:

- **streamed**: a host store (optionally int8 delta-packed,
  :mod:`.quant`) and a double-buffered prefetch thread
  (:mod:`.pipeline`) copying chunk k+1 through pinned buffers on a side
  CUDA stream under chunk k's solve;
- **synthesized**: a seeded generator (:mod:`.synth` on the
  jax-semantics threefry of :mod:`.prng`) makes the rhs/bound
  perturbations on the device from ``(seed, scenario_id)``; nothing is
  copied.
"""

from .pipeline import ChunkPipeline, H2DStager               # noqa: F401
from .quant import (Int8Field, dequantize,                    # noqa: F401
                    dequantize_cols, quantize_field)
from .source import (ScenarioSource, StreamedSource,          # noqa: F401
                     SynthesizedSource, make_source)
from .synth import (SOURCE_FIELDS, SYNTH_FIELDS,              # noqa: F401
                    SynthField, SynthSpec, materialize, synth_batch,
                    synth_values)
