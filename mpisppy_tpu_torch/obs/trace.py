"""Span recording + Chrome trace-event export (the port of the JAX
package's obs/trace.py).

Spans are host wall-clock intervals (``time.perf_counter`` pairs)
buffered as Chrome trace-event "X" (complete) records and written as
one ``trace.json`` loadable in Perfetto / chrome://tracing. The PH
pipeline phases (assemble/solve/gate/reduce), per-chunk solves and
per-chunk lanes all land here; lanes map to Chrome ``tid`` so
concurrent work renders as parallel tracks.

Two recording styles:
 - ``complete(name, t0, t1)`` — the hot-loop style: the caller already
   holds the perf_counter marks (PH's ``_lap`` accounting), so the span
   costs one list append and stays EXACTLY consistent with
   ``PHBase.phase_timing`` (same timestamps, same totals).
 - ``span(name)`` — a context manager for code that isn't already
   timing itself. It bridges to the torch profiler and to NVTX, so a
   ``torch.profiler`` or nsys capture groups the device work a span
   issued under the span's name (the JAX package's TraceAnnotation
   bridge): ``torch.autograd.profiler.record_function`` while a torch
   profiler is recording (or always, with ``annotations=True``), and
   ``torch.cuda.nvtx.range_push/pop`` with ``annotations=True`` on a
   process whose CUDA context is up. Neither touches a stream, so the
   bridge adds no sync; with no profiler and no ``annotations`` it
   does nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time


def _profiler_recording() -> bool:
    """Whether a torch (autograd/kineto) profiler is recording in this
    process: the consumer that asks for ``record_function`` ranges."""
    try:
        import torch
        return bool(torch.autograd._profiler_enabled())
    except Exception:
        return False


def _nvtx_ready() -> bool:
    try:
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:
        return False


class Span:
    """Context-manager span; records a complete event on exit."""

    __slots__ = ("_buf", "name", "cat", "args", "lane", "_t0", "_rf",
                 "_nvtx")

    def __init__(self, buf, name, cat, args, lane):
        self._buf = buf
        self.name = name
        self.cat = cat
        self.args = args
        self.lane = lane
        self._t0 = None
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        ann = self._buf.annotations
        if ann or _profiler_recording():
            try:
                from torch.autograd.profiler import record_function
                self._rf = record_function(self.name)
                self._rf.__enter__()
            except Exception:   # profiler unavailable: host span only
                self._rf = None
        if ann and _nvtx_ready():
            try:
                import torch
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
            except Exception:
                self._nvtx = False
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._buf.complete(self.name, self._t0, t1, cat=self.cat,
                           args=self.args, lane=self.lane)
        return False


class TraceBuffer:
    """In-memory Chrome trace-event buffer, flushed to one JSON file."""

    def __init__(self, path=None, run_id=None, annotations=False,
                 role=None):
        self.path = path
        self.run_id = run_id
        self.role = role
        self.annotations = bool(annotations)
        self._lock = threading.Lock()
        self._events = []
        self._pid = os.getpid()
        # (wall clock, perf_counter) pair read back-to-back: the only
        # sanctioned way to put this process's monotonic span stamps on
        # a cross-process timeline (obs/merge.py aligns role traces
        # from exactly this anchor)
        self.anchor = {"wall_time_unix": time.time(),
                       "perf_counter": time.perf_counter()}
        self._lanes = {}          # lane name -> tid + emitted metadata
        name = f"mpisppy_tpu_torch:{run_id or self._pid}"
        if role:
            name += f":{role}"
        self._meta(self._pid, 0, "process_name", {"name": name})

    def _meta(self, pid, tid, name, args):
        self._events.append({"name": name, "ph": "M", "pid": pid,
                             "tid": tid, "args": args})

    def _tid(self, lane):
        """Map a logical lane (None = host thread, str = named track
        like ``dev0``) to a stable Chrome tid, emitting thread_name
        metadata on first use."""
        if lane is None:
            return threading.get_ident() % 2 ** 31
        tid = self._lanes.get(lane)
        if tid is None:
            tid = self._lanes[lane] = 1 + len(self._lanes)
            self._meta(self._pid, tid, "thread_name", {"name": str(lane)})
        return tid

    def complete(self, name, t0, t1, cat="host", args=None, lane=None):
        """Record a complete ("X") span from explicit perf_counter
        marks; timestamps convert to the microseconds Chrome expects."""
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
              "pid": self._pid}
        with self._lock:
            ev["tid"] = self._tid(lane)
            if args:
                ev["args"] = args
            self._events.append(ev)

    def span(self, name, cat="host", args=None, lane=None):
        return Span(self, name, cat, args, lane)

    def to_json(self, nonblocking=False):
        """Trace dict, or None when ``nonblocking`` and the lock is
        held (signal-handler context: the interrupted frame underneath
        may own it — blocking there would self-deadlock)."""
        if nonblocking:
            if not self._lock.acquire(blocking=False):
                return None
        else:
            self._lock.acquire()
        try:
            return {"traceEvents": list(self._events),
                    "displayTimeUnit": "ms",
                    "metadata": {"run_id": self.run_id,
                                 "role": self.role,
                                 "clock": "perf_counter_us",
                                 **self.anchor}}
        finally:
            self._lock.release()

    def flush(self, nonblocking=False):
        """Atomically (re)write the whole trace file. Nonblocking mode
        skips (returns) when the buffer lock is unavailable."""
        if self.path is None:
            return
        data = self.to_json(nonblocking=nonblocking)
        if data is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)
