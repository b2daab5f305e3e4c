"""Cylinders: concurrent algorithm instances exchanging bounds/weights.

The reference runs each cylinder as a block of MPI ranks and exchanges
state through one-sided RMA windows with a write-id freshness protocol
(ref. mpisppy/cylinders/spcommunicator.py:3-14, 97-124). The TPU redesign
runs cylinders as host threads (or processes via the native shared-memory
backend, see ops/native) sharing a single accelerator: device work is
serialized by the runtime, host coordination is asynchronous, and the
write-id semantics are preserved exactly so the algorithms' staleness
tolerances carry over.

``SPOKE_SLEEP_TIME`` rate-limits spoke kill-signal polling like the
reference's module knob (ref. mpisppy/cylinders/__init__.py:3).
"""

SPOKE_SLEEP_TIME = 0.01
