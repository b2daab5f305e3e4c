"""Durable run-state checkpoints (the port of the JAX package's ckpt/;
doc/fault_tolerance.md §checkpoints).

The reference's only checkpoint mechanism is a CSV round-trip of
(W, x̄) (ref. mpisppy/utils/wxbarutils.py, SURVEY §5.4). Cards in a
preemptible pool are taken away, so a production wheel needs the whole
run state — hub algorithm tensors, best bounds, per-spoke warm state —
captured durably and restored on relaunch. This package is that
subsystem:

- :mod:`bundle` — the on-disk format: a manifest'd directory written
  atomically (tmp + ``os.replace``, the live.json pattern), carrying
  ``hub.npz`` + per-spoke warm-state blocks + ``manifest.json`` with a
  schema version and a config fingerprint; ``LATEST`` pointer +
  last-N retention. The format is the JAX package's: a bundle written
  by either package resumes a wheel of the other.
- :mod:`spoke_state` — tiny per-spoke warm-state files (best bound,
  Lagrangian duals, cycler position, dive round), written atomically
  by each spoke into ``<ckpt_dir>/spokes/`` and handed back to
  resumed/respawned incarnations.
- :mod:`manager` — the hub-owned :class:`CheckpointManager`: periodic
  capture from the termination-check path, forced capture on watchdog
  fire / SIGTERM (the preemption notice), and the resume installer
  that validates a bundle before touching the engine.

``bundle`` and ``spoke_state`` are numpy + stdlib; ``manager`` reads
the engine's tensors only when it captures or installs.
"""

from .bundle import (SCHEMA_VERSION, CheckpointError, config_fingerprint,
                     latest_bundle, load_bundle, resolve_bundle,
                     validate_state_arrays, write_bundle)
from .manager import CheckpointManager, resume_hub
from .spoke_state import (load_spoke_state, save_spoke_state,
                          spoke_state_path)

__all__ = [
    "SCHEMA_VERSION", "CheckpointError", "CheckpointManager",
    "config_fingerprint", "latest_bundle", "load_bundle",
    "load_spoke_state", "resolve_bundle", "resume_hub",
    "save_spoke_state", "spoke_state_path", "validate_state_arrays",
    "write_bundle",
]
