"""Unified telemetry for the port: metrics, events, traces (the port of
the JAX package's obs/ facade, with its artifact names, event names
and counter names, so ``analyze`` reads a port run unchanged).

One process-wide telemetry session writes three artifacts:

 - ``events.jsonl`` — structured event stream (monotonic stamps, run
   id, config snapshot in the ``run_header`` line, SCHEMA_VERSION 2),
 - ``trace.json``  — Chrome trace-event spans of the PH pipeline
   phases (load into Perfetto / chrome://tracing),
 - ``metrics.json``— counters / gauges / histograms snapshot.

This module is the FACADE the rest of the package calls: module-level
functions that forward to the process-wide :class:`Recorder` when one
is configured and do (almost) nothing when not. The disabled path is a
single global read + ``is None`` test per call and allocates nothing —
``span(...)`` returns a shared no-op singleton — so instrumentation
lives permanently on the PH hot loop.

Usage::

    from mpisppy_tpu_torch import obs
    obs.configure(out_dir="runs/t1")        # or None for in-memory
    obs.counter_add("ph.gate_syncs")
    obs.event("hub.bound", {"kind": "outer", "value": -1.5})
    with obs.span("ph.iteration", args={"iter": 3}):
        ...
    obs.shutdown()

``events()`` reads the session's events back as ``(type, record)``
pairs (an in-memory session keeps all of them, a file session the
last 4096); tests and chip_smoke.py check runs through it.

Environment: ``MPISPPY_TPU_TELEMETRY_DIR`` — when set, the first call
to :func:`maybe_configure_from_env` (the CLI, the process wheels)
enables telemetry into that directory without code changes.
"""

from __future__ import annotations

import atexit
import math
import os

from .metrics import Histogram, MetricsRegistry        # noqa: F401
from .events import EventStream, SCHEMA_VERSION        # noqa: F401
from .trace import Span, TraceBuffer                   # noqa: F401
from .recorder import Recorder                         # noqa: F401

_TELEMETRY_ENV = "MPISPPY_TPU_TELEMETRY_DIR"

_REC: Recorder | None = None


class _NullSpan:
    """Shared no-op context manager: the disabled-mode ``span()``
    result. A singleton so disabled spans allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def configure(out_dir=None, run_id=None, config=None, annotations=False,
              role=None) -> Recorder:
    """Start (or replace) the process-wide telemetry session. The old
    session, if any, is closed first. ``out_dir=None`` records
    in-memory only (no files). ``role`` suffixes the artifact filenames
    (``events-<role>.jsonl`` …) so multi-process cylinder runs can
    share one directory (utils/multiproc.py and core/aph_shard.py set
    it for their children). ``annotations`` turns the spans' NVTX and
    profiler ranges on for a whole session (obs/trace.py)."""
    global _REC
    if _REC is not None:
        _REC.close()
    _REC = Recorder(out_dir=out_dir, run_id=run_id, config=config,
                    annotations=annotations, role=role)
    return _REC


def maybe_configure_from_env(role=None) -> Recorder | None:
    """Enable telemetry when MPISPPY_TPU_TELEMETRY_DIR is set (no-op
    when unset or when a session is already active)."""
    d = os.environ.get(_TELEMETRY_ENV)
    if d and _REC is None:
        return configure(out_dir=d, role=role)
    return _REC


def shutdown():
    """Close the process-wide session (flushes all artifacts)."""
    global _REC
    if _REC is not None:
        _REC.close()
        _REC = None


@atexit.register
def _atexit_close():
    # a crash-free exit persists trace.json/metrics.json even when the
    # caller never called shutdown(); events streamed incrementally
    shutdown()


def active() -> Recorder | None:
    return _REC


def enabled() -> bool:
    return _REC is not None


# ---- hot-path forwarding (each: one global read + None test) ----
def event(etype, fields=None, t=None):
    r = _REC
    if r is not None:
        r.event(etype, fields, t=t)


def counter_add(name, n=1):
    r = _REC
    if r is not None:
        r.metrics.counter_add(name, n)


def gauge_set(name, value):
    r = _REC
    if r is not None:
        r.metrics.gauge_set(name, value)


def histogram_observe(name, value):
    r = _REC
    if r is not None:
        r.metrics.histogram_observe(name, value)


def span(name, cat="host", args=None, lane=None):
    r = _REC
    if r is None:
        return _NULL_SPAN
    return r.span(name, cat=cat, args=args, lane=lane)


def complete_span(name, t0, t1, cat="host", args=None, lane=None):
    r = _REC
    if r is not None:
        r.trace.complete(name, t0, t1, cat=cat, args=args, lane=lane)


def counters_snapshot() -> dict:
    """Copy of the counter map ({} when telemetry is disabled). Taken
    under the registry lock — spoke cylinder threads may be
    inserting new keys concurrently."""
    r = _REC
    return r.metrics.counters_snapshot() if r is not None else {}


def counter_value(name) -> float:
    """One counter's value (0 when telemetry is disabled or the counter
    was never booked)."""
    r = _REC
    return r.metrics.counter_get(name) if r is not None else 0


def histogram_snapshot(name) -> dict | None:
    """Snapshot of one histogram (None when disabled or never
    observed) — the hub's bound-flow status reads staleness tails
    through this."""
    r = _REC
    return r.metrics.histogram_get(name) if r is not None else None


def events(etype=None) -> list:
    """The session's events as ``(type, record)`` pairs, optionally
    only those of one type ([] when disabled)."""
    r = _REC
    if r is None:
        return []
    with r.events._lock:
        tail = list(r.events.tail)
    return [(e["type"], e) for e in tail
            if etype is None or e.get("type") == etype]


def flush(nonblocking=False):
    """Persist artifacts. ``nonblocking=True`` is for signal handlers:
    skips any sink whose lock the interrupted frame holds."""
    r = _REC
    if r is not None:
        r.flush(nonblocking=nonblocking)


def finite_or_none(v):
    """THE sanitizer for bound/gap fields in telemetry events: None for
    absent or non-finite values (never-established bounds are ±inf,
    which strict-JSON consumers reject), a plain float otherwise."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None
