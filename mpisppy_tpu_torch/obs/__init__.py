"""Minimal in-process telemetry with the names the engine and the
wheel call (counters, events, spans, histograms, gauges) — the port's
copy of the JAX package's obs/ facade, recording in memory only.

Disabled by default: every call is then one global read and a ``None``
test. ``configure()`` starts a session; ``events()`` and
``counters_snapshot()`` read it back (tests and chip_smoke.py use them
to check, e.g., that no kernel demotion was booked). Cylinder threads
write concurrently, so the containers are guarded by one lock. File
artifacts (events.jsonl, trace.json, metrics.json) are not ported
(ROADMAP.md A13): ``configure(out_dir=...)`` and the telemetry
environment variable raise.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import defaultdict

_TELEMETRY_ENV = "MPISPPY_TPU_TELEMETRY_DIR"


class Recorder:
    """One telemetry session: counters, gauges, histograms, events,
    spans — plain Python containers under one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.counters = defaultdict(float)
        self.gauges = {}
        self.histograms = defaultdict(list)
        self.events = []
        self.spans = []


_REC: Recorder | None = None


def _no_files(what):
    return NotImplementedError(
        f"{what}: telemetry files are not ported yet; the port records "
        "in memory only (see ROADMAP.md A13)")


def configure(out_dir=None) -> Recorder:
    """Start (or replace) the process-wide in-memory session."""
    global _REC
    if out_dir is not None:
        raise _no_files(f"obs.configure(out_dir={out_dir!r})")
    _REC = Recorder()
    return _REC


def maybe_configure_from_env() -> Recorder | None:
    """The JAX package enables file telemetry when its environment
    variable is set; the port has no file telemetry, so it refuses
    instead of running without the files that were asked for."""
    if os.environ.get(_TELEMETRY_ENV) and _REC is None:
        raise _no_files(f"{_TELEMETRY_ENV} is set")
    return _REC


def shutdown() -> None:
    global _REC
    _REC = None


def active() -> Recorder | None:
    return _REC


def enabled() -> bool:
    return _REC is not None


def flush(nonblocking=False):
    """Persist artifacts: an in-memory session has none."""


def counter_add(name, value=1):
    r = _REC
    if r is not None:
        with r.lock:
            r.counters[name] += value


def counters_snapshot() -> dict:
    r = _REC
    if r is None:
        return {}
    with r.lock:
        return dict(r.counters)


def gauge_set(name, value):
    r = _REC
    if r is not None:
        with r.lock:
            r.gauges[name] = value


def histogram_observe(name, value):
    r = _REC
    if r is not None:
        with r.lock:
            r.histograms[name].append(float(value))


def histogram_snapshot(name) -> dict | None:
    """count / mean / p50 / p99 / max of one histogram (None when
    disabled or never observed)."""
    r = _REC
    if r is None:
        return None
    with r.lock:
        vals = sorted(r.histograms.get(name, ()))
    if not vals:
        return None

    def q(p):
        return vals[min(len(vals) - 1, int(p * len(vals)))]

    return {"count": len(vals), "mean": sum(vals) / len(vals),
            "p50": q(0.5), "p99": q(0.99), "max": vals[-1]}


def event(etype, fields=None, t=None):
    """Book one event, stamped ``t`` (perf_counter; now by default)."""
    r = _REC
    if r is not None:
        rec = dict(fields or {})
        rec["t"] = time.perf_counter() if t is None else t
        with r.lock:
            r.events.append((etype, rec))


def events(etype=None) -> list:
    """Booked events, optionally only those of one type."""
    r = _REC
    if r is None:
        return []
    with r.lock:
        return [e for e in r.events if etype is None or e[0] == etype]


def complete_span(name, t0, t1, cat=None, args=None):
    r = _REC
    if r is not None:
        with r.lock:
            r.spans.append((name, t0, t1, cat, args))


def finite_or_none(v):
    """None for absent or non-finite values (never-established bounds
    are ±inf, which strict-JSON consumers reject), a float otherwise."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None
