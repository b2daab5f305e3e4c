"""The Recorder: one telemetry session = metrics + events + trace (a
copy of the JAX package's obs/recorder.py; the port installs no compile
hooks, since it has no jit compiles to count).

A Recorder owns the three sinks for one run:
 - :class:`.metrics.MetricsRegistry` (counters/gauges/histograms),
 - :class:`.events.EventStream` (``events.jsonl``),
 - :class:`.trace.TraceBuffer` (``trace.json``).

``flush()`` persists the trace file and a ``metrics.json`` snapshot
(events stream incrementally on their own); ``close()`` flushes, emits
a final ``run_footer`` event carrying the metrics snapshot, and closes
the stream. The module facade (``obs/__init__.py``) holds
the process-wide instance; construct Recorders directly only for
isolated captures (tests).

``role`` names this process's place in a multi-process cylinder run
(e.g. ``spoke0-lagrangian``): artifacts become ``events-<role>.jsonl``
/ ``trace-<role>.json`` / ``metrics-<role>.json`` so every process of
a wheel can write into ONE shared run directory without clobbering the
hub's un-suffixed files. ``obs/merge.py`` joins the role traces onto
one wall-clock-aligned timeline after the wheel terminates.
"""

from __future__ import annotations

import json
import os
import time

from .events import EventStream
from .metrics import MetricsRegistry
from .trace import TraceBuffer


def _suffixed(name, ext, role):
    return f"{name}-{role}{ext}" if role else f"{name}{ext}"


class Recorder:
    def __init__(self, out_dir=None, run_id=None, config=None,
                 annotations=False, role=None):
        self.out_dir = out_dir
        self.role = role
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.run_id = run_id or f"run-{int(time.time())}-{os.getpid()}"
        self.metrics = MetricsRegistry()
        self.events = EventStream(
            path=os.path.join(out_dir, _suffixed("events", ".jsonl", role))
            if out_dir else None,
            run_id=self.run_id, config=config, role=role,
            # an in-memory session keeps every event (tests and
            # chip_smoke.py read them back through obs.events())
            tail=4096 if out_dir else None)
        self.trace = TraceBuffer(
            path=os.path.join(out_dir, _suffixed("trace", ".json", role))
            if out_dir else None,
            run_id=self.run_id, annotations=annotations, role=role)
        self._closed = False

    # thin sink forwarding — these five are the whole hot-path surface
    def event(self, etype, fields=None, t=None):
        return self.events.event(etype, fields, t=t)

    def counter_add(self, name, n=1):
        self.metrics.counter_add(name, n)

    def gauge_set(self, name, value):
        self.metrics.gauge_set(name, value)

    def histogram_observe(self, name, value):
        self.metrics.histogram_observe(name, value)

    def span(self, name, cat="host", args=None, lane=None):
        return self.trace.span(name, cat=cat, args=args, lane=lane)

    def complete_span(self, name, t0, t1, cat="host", args=None,
                      lane=None):
        self.trace.complete(name, t0, t1, cat=cat, args=args, lane=lane)

    def flush(self, nonblocking=False):
        """Persist trace.json + metrics.json. ``nonblocking`` is for
        SIGNAL-HANDLER callers (bench's SIGTERM flush): the interrupted
        main-thread frame may hold a sink lock, and a blocking acquire
        there would deadlock the kill path — skip whatever is locked
        instead."""
        self.trace.flush(nonblocking=nonblocking)
        if self.out_dir:
            snap = self.metrics.snapshot(nonblocking=nonblocking)
            if snap is None:
                return
            path = os.path.join(
                self.out_dir, _suffixed("metrics", ".json", self.role))
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"run_id": self.run_id, **snap}, f, indent=1)
            os.replace(tmp, path)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.events.event("run_footer",
                          {"run_id": self.run_id,
                           "metrics": self.metrics.snapshot()})
        self.flush()
        self.events.close()
