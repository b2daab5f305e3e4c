"""Communication windows + SPCommunicator base.

Mirrors the reference's RMA-window discipline (ref. mpisppy/cylinders/
spcommunicator.py:23-124): every buffer is ``length + 1`` doubles whose
last slot is a monotonically increasing write-id; readers detect fresh
data by comparing ids; ``-1`` is the reserved kill value
(ref. mpisppy/cylinders/hub.py:356-368). Ownership discipline matches
Lock/Put/Unlock: only the owner writes, remotes read under the lock.

The default backend is an in-process ``threading.Lock`` + numpy buffer;
``Window.shared(...)`` swaps in the native shared-memory backend for
cylinders and scenario shards run as processes (the same protocol over
POSIX shared memory with a seqlock, ops/native/spwindow.cpp, built from
source at first use).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

# ---- bound-flow lineage (doc/observability.md "live plane") ----
# Every spoke→hub window carries a 3-double lineage SUFFIX behind the
# semantic payload: [publish seq, compute stamp, publish stamp].
#  - publish seq: per-spoke monotonically increasing PUBLISH counter.
#    Distinct from the window write-id, which also advances on idle
#    heartbeat re-stamps (cylinders/spoke._heartbeat) — the seq is how
#    the hub tells a fresh bound from a pulse, and how it counts
#    publishes it never saw (the window overwrites in place, so a slow
#    reader observes the seq jump).
#  - compute/publish stamps: ``time.time()`` wall clock — the one clock
#    hub and spoke PROCESSES share (perf_counter is per-process
#    monotonic and cannot cross a process boundary). Staleness
#    (hub read − spoke publish) therefore carries NTP-slew noise, which
#    is harmless at the >=0.1 s granularity bound flow cares about.
# NaN lineage (the all-NaN startup hello, hand-built test payloads)
# means "no lineage": the hub ingests the payload but books nothing.
LINEAGE_SLOTS = 3


def wire_payload(values, seq, t_compute=None, t_publish=None):
    """Semantic payload + lineage suffix -> the on-wire array."""
    import time

    values = np.asarray(values, dtype=np.float64).reshape(-1)
    now = time.time()
    out = np.empty(values.shape[0] + LINEAGE_SLOTS)
    out[:-LINEAGE_SLOTS] = values
    out[-3] = float(seq)
    out[-2] = now if t_compute is None else float(t_compute)
    out[-1] = now if t_publish is None else float(t_publish)
    return out


def split_wire(values):
    """On-wire array -> (payload view, seq, t_compute, t_publish)."""
    return (values[:-LINEAGE_SLOTS], float(values[-3]),
            float(values[-2]), float(values[-1]))


class Window:
    """A one-writer many-reader buffer with the write-id protocol."""

    KILL = -1

    def __init__(self, length: int):
        self.length = int(length)
        self.buf = np.zeros(self.length + 1)
        self.lock = threading.Lock()

    # -- owner side (ref. hub.py:310-331 hub_to_spoke / spoke.py:59-80) --
    def put(self, values) -> int:
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        assert values.shape[0] == self.length, \
            f"window length {self.length} != payload {values.shape[0]}"
        with self.lock:
            self.buf[:-1] = values
            if self.buf[-1] >= 0:
                self.buf[-1] += 1
            return int(self.buf[-1])

    def kill(self):
        """Write the terminate signal (write-id -1, ref. hub.py:356)."""
        with self.lock:
            self.buf[-1] = Window.KILL

    # -- reader side (ref. hub.py:333-354 hub_from_spoke / spoke.py:82-99) --
    def read(self):
        """Return (values copy, write_id)."""
        with self.lock:
            return self.buf[:-1].copy(), int(self.buf[-1])

    def read_id(self) -> int:
        with self.lock:
            return int(self.buf[-1])

    @staticmethod
    def shared(name: str, length: int, create: bool):
        """The native shared-memory backend (ops/native): the same
        write-id protocol over POSIX shm with a seqlock, for cylinders
        running as separate PROCESSES (the reference's MPI-RMA star,
        ref. spcommunicator.py:97-124)."""
        return SharedWindow(name, length, create)


class SharedWindow:
    """One-writer many-reader shared-memory window (see ops/native).
    ``create=True`` makes the segment (its owner unlinks it on close);
    ``create=False`` opens an existing one and raises OSError when it
    is not there yet."""

    KILL = -1

    def __init__(self, name: str, length: int, create: bool):
        from ..ops import native

        self._lib = native.load()
        self.name = name
        self.length = int(length)
        fn = self._lib.spw_create if create else self._lib.spw_open
        self._h = fn(name.encode(), self.length)
        if not self._h:
            raise OSError(f"could not {'create' if create else 'open'} "
                          f"shared window {name!r}")
        self._owner = bool(create)

    def put(self, values) -> int:
        import ctypes

        values = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
        if values.shape[0] != self.length:
            raise ValueError(f"window length {self.length} != payload "
                             f"{values.shape[0]}")
        self._lib.spw_put(self._h, values.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), self.length)
        return self.read_id()

    def kill(self):
        # tolerate a closed handle: the terminate sweep may visit a
        # window another path has since retired
        if self._h:
            self._lib.spw_kill(self._h)

    def read(self):
        import ctypes

        out = np.empty(self.length, dtype=np.float64)
        wid = self._lib.spw_read(self._h, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), self.length)
        return out, int(wid)

    def read_id(self) -> int:
        return int(self._lib.spw_read_id(self._h))

    def close(self, unlink=None):
        if self._h:
            self._lib.spw_close(self._h, 1 if (self._owner if unlink is None
                                               else unlink) else 0)
            self._h = None


class SPCommunicator:
    """Base of Hub and Spoke: owns an algorithm (`opt`) instance and the
    window pair used to talk across the strata (ref. spcommunicator.py:23).

    Window topology is the reference's star graph: for each spoke there is
    one hub-owned window (hub writes; that spoke reads) and one spoke-owned
    window (spoke writes; hub reads)."""

    def __init__(self, spbase_object, options=None):
        self.opt = spbase_object
        # Communicator options LAYER OVER the engine's: vanilla puts
        # SpokeConfig.options into the ENGINE (opt_kwargs["options"]),
        # and spin_the_wheel builds communicators with no options of
        # their own — without the merge, every spoke-level knob
        # (lagrangian_exact_oracle, xhat_scen_limit, ...) configured
        # through the config tree would be silently dead.
        self.options = dict(getattr(spbase_object, "options", {}) or {})
        self.options.update(options or {})
        # back-pointer used by engines to call sync() mid-iteration
        # (ref. spbase.py:503-514 weakref spcomm setter)
        self.opt.spcomm = weakref.proxy(self)
        self.windows_made = False

    # sizes the subclass must declare before make_windows()
    def local_window_length(self) -> int:
        """Length of the buffer THIS cylinder writes."""
        raise NotImplementedError

    def remote_window_length(self) -> int:
        """Length of the buffer this cylinder reads."""
        raise NotImplementedError

    def finalize(self):
        """Post-kill wrap-up; returns a cylinder-specific result."""
        return None

    def allreduce_or(self, flag: bool) -> bool:
        """Degenerate in-process analog of allreduce(LOR)
        (ref. spcommunicator.py:79): single shared address space."""
        return bool(flag)
