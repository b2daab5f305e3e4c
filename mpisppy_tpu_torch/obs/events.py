"""Structured JSONL event stream.
(A copy of the JAX package's obs/events.py; the port keeps its own.)

One line per event: ``{"t": <perf_counter>, "type": <str>, ...fields}``.
``t`` is ``time.perf_counter()`` — MONOTONIC, jitter-proof under NTP
slews — and the stream's first line is a ``run_header`` recording the
(wall_time_unix, perf_counter) anchor pair plus the run id and a config
snapshot, so any consumer can convert monotonic stamps to wall clock
and merge streams from concurrent processes. This stream subsumes the
historical scatter of per-module sinks: spoke ``trace_prefix`` CSVs,
hub ``bound_events``, PH hospital/recovery screen traces, and the
``MPISPPY_TPU_SOLVE_TRACE`` stderr stamps all emit here when telemetry
is configured (doc/observability.md documents every event type).

Lines are written incrementally (line-buffered append) so a killed run
keeps everything emitted before the kill; a bounded in-memory tail is
kept for tests and interactive consumers that never touch the disk.

Rotation: a serve-hosted process lives for days, so the stream is
size-capped — when the current file passes ``max_bytes`` (default
256 MiB, ``MPISPPY_TPU_TELEMETRY_ROTATE_BYTES``) it is renamed to
``events.jsonl.1`` (older files shift to ``.2..N``, the oldest beyond
``MPISPPY_TPU_TELEMETRY_ROTATE_FILES``, default 8, is dropped) and a
fresh file opens with a CONTINUATION HEADER — the original
``run_header`` plus a ``rotated: <k>`` field — so every consumer that
anchors on the first line (``obs/merge.py``) keeps working, and
``analyze`` re-chains the files oldest-first into one logical stream
(a header carrying ``rotated`` is a splice point, not a new session).
A ``telemetry.rotated`` event opens each new file after the header.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

# Telemetry artifact schema version, stamped into every run_header (and
# by bench.py into its BENCH JSON rows). Consumers that join artifacts
# across runs (``analyze --compare``) refuse mismatched versions instead
# of mis-parsing. Bump when an event/trace/metrics field changes
# meaning; absent = 1 (the first format).
SCHEMA_VERSION = 2

# rotation defaults (documented in doc/observability.md): cap one
# events file at 256 MiB, keep 8 rotated generations
_ROTATE_BYTES_DEFAULT = 256 * 1024 * 1024
_ROTATE_FILES_DEFAULT = 8


def _env_int(name, default):
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


class EventStream:
    """Append-only JSONL sink with a bounded in-memory tail."""

    def __init__(self, path=None, run_id=None, config=None, tail=4096,
                 role=None, max_bytes=None, max_files=None):
        self.path = path
        self.run_id = run_id
        self.max_bytes = max_bytes if max_bytes is not None else \
            _env_int("MPISPPY_TPU_TELEMETRY_ROTATE_BYTES",
                     _ROTATE_BYTES_DEFAULT)
        self.max_files = max_files if max_files is not None else \
            _env_int("MPISPPY_TPU_TELEMETRY_ROTATE_FILES",
                     _ROTATE_FILES_DEFAULT)
        self.rotations = 0
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1) if path else None
        self._bytes = 0
        if path:
            try:
                self._bytes = os.path.getsize(path)
            except OSError:
                pass
        self.tail = deque(maxlen=tail)
        self.emitted = 0
        self.header = {
            "type": "run_header",
            "schema": SCHEMA_VERSION,
            "run_id": run_id,
            "role": role,
            "t": time.perf_counter(),
            "wall_time_unix": time.time(),
            "wall_time_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "clock": "perf_counter",
            "config": config,
        }
        self._write(self.header)

    def event(self, etype: str, fields=None, t=None):
        """Emit one event. ``t`` defaults to now (perf_counter); pass an
        explicit stamp to record an event measured earlier (e.g. hub
        bound events re-emitted with their original stamps)."""
        obj = {"t": time.perf_counter() if t is None else float(t),
               "type": etype}
        if fields:
            obj.update(fields)
        self._write(obj)
        return obj

    def _write(self, obj):
        with self._lock:
            self.tail.append(obj)
            self.emitted += 1
            if self._fh is None:
                return
            try:
                line = json.dumps(obj, default=_jsonable)
            except ValueError:
                # unserializable event (e.g. a circular reference the
                # default hook never sees): drop THIS line only — the
                # sink must stay alive for every later event
                return
            try:
                self._fh.write(line + "\n")
                self._bytes += len(line) + 1
            except ValueError:
                # stream closed under us (interpreter teardown races
                # the atexit flush) — keep the memory tail
                self._fh = None
                return
            if self.max_bytes and self._bytes >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self):
        """Shift the current file to ``.1`` (``.k`` -> ``.k+1``, the
        oldest dropped) and reopen fresh, first line a continuation
        header. Caller holds ``self._lock``; writes go through the
        file handle directly — no re-entry into ``_write``."""
        try:
            self._fh.close()
            for k in range(self.max_files - 1, 0, -1):
                src = f"{self.path}.{k}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{k + 1}")
            drop = f"{self.path}.{self.max_files}"
            if os.path.exists(drop):
                os.remove(drop)
            os.replace(self.path, f"{self.path}.1")
            self._fh = open(self.path, "a", buffering=1)
        except OSError:
            # a hostile filesystem must not kill the emitting hot
            # path: reopen in place (uncapped) and carry on
            try:
                self._fh = open(self.path, "a", buffering=1)
            except OSError:
                self._fh = None
            self._bytes = 0
            return
        self.rotations += 1
        self._bytes = 0
        # continuation header: the ORIGINAL anchor pair + run id with a
        # rotation marker, so first-line consumers (merge anchors)
        # still see a run_header and analyze knows not to treat the
        # splice as a new session
        for obj in (dict(self.header, rotated=self.rotations),
                    {"t": time.perf_counter(),
                     "type": "telemetry.rotated",
                     "seq": self.rotations,
                     "max_bytes": self.max_bytes,
                     "max_files": self.max_files}):
            try:
                self._fh.write(json.dumps(obj, default=_jsonable)
                               + "\n")
            except (ValueError, OSError):
                return

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _jsonable(o):
    """Last-resort JSON coercion: numpy scalars/arrays and anything
    else stringify instead of killing the emitting hot path."""
    try:
        import numpy as np
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.generic):
            return o.item()
    except Exception:
        pass
    return str(o)
