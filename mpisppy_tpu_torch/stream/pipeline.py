"""The double-buffered chunk prefetch pipeline and its host-to-device
transfer path (the port of mpisppy_tpu/stream/pipeline.py).

``ChunkPipeline``: one daemon host thread walks the chunk sequence
ahead of the solve loop, staging each chunk's device blocks into a
bounded queue: while the card solves chunk k, the thread is already
copying chunk k+1. The queue bound (``depth``, default 2) is the double
buffer: the producer blocks once ``depth`` chunks are staged, so the
staged device blocks never exceed ``depth`` chunks whatever S is. The
loop consumes chunks strictly in order (``get(ci)``), in passes;
``start_pass()`` rewinds the producer to chunk 0 and discards the
blocks of a superseded pass. A GATED pass (``start_pass(gated=True)``,
the solve pass) stages chunk k+1 only once the consumer has released
chunk k (``release(k, event)``, just before it enqueues chunk k's
solve), and the copy waits on that event: chunk k+1 crosses the bus
while chunk k solves, and never before. ``close()`` is idempotent and joins the
thread, which is a daemon besides. ``get`` polls the queue every 50 ms
and books ``stream.prefetch_stalls`` and the
``stream.prefetch_stall_seconds`` histogram when the consumer outran
the producer.

``H2DStager``: the card's transfer path, owned by the producer thread.

- A ring of PINNED host buffers, allocated at the first chunk of a
  layout and reused (a ``pin_memory()`` per chunk would be a
  cudaHostAlloc per chunk); before a slot's buffer is overwritten the
  host waits on that slot's last copy event.
- ``non_blocking`` copies on a side CUDA stream (the stream context is
  thread-local: the producer thread sets the device and enters the
  stream itself), then one CUDA event per staged chunk.
- The consumer (``adopt``) makes its own stream wait on the event, so
  the host never blocks on the copy, and ``record_stream``s every
  device tensor of the block onto its stream, so the caching allocator
  does not hand the memory back to the side stream while the solve
  still reads it.

On the CPU the same classes run with plain copies.
"""

from __future__ import annotations

import queue
import threading
import time as _time

import numpy as np
import torch

from .. import obs


class ChunkPipeline:
    """``loader(ci) -> block`` run ``depth`` chunks ahead on a host
    thread. The loader owns the transfer and its byte accounting; the
    pipeline owns ordering, backpressure and stall accounting.
    ``device``: the CUDA device the producer thread works on (its
    current device is thread-local); None on the CPU."""

    def __init__(self, loader, n_chunks: int, depth: int = 2,
                 name: str = "stream-prefetch", device=None):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.loader = loader
        self.n_chunks = int(n_chunks)
        self.depth = int(depth)
        if device is not None and device.index is None:
            # set_device needs an index: the constructing thread's card
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._q = queue.Queue(maxsize=self.depth)
        self._wake = threading.Event()
        self._stop = False
        self._gen = 0            # pass generation; bumped by start_pass
        self._lock = threading.Lock()
        # gated passes: the consumer's releases of this generation
        self._cond = threading.Condition()
        self._gated = False
        self._released = {}      # chunk -> event (or None)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._started = False

    # ---- producer ----
    def _run(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            self._wake.wait()
            if self._stop:
                return
            with self._lock:
                gen = self._gen
                gated = self._gated
                self._wake.clear()
            for ci in range(self.n_chunks):
                if self._stop or self._gen != gen:
                    break
                after = None
                if gated and ci > 0:
                    ok, after = self._wait_release(gen, ci - 1)
                    if not ok:
                        break
                try:
                    blk = self.loader(ci) if after is None \
                        else self.loader(ci, after)
                except Exception as e:       # surfaced by get()
                    self._q_put((gen, ci, None, e))
                    break
                if not self._q_put((gen, ci, blk, None)):
                    break

    def _wait_release(self, gen, ci):
        """(True, event) once the consumer released chunk ``ci`` of pass
        ``gen``; (False, None) when the pass was superseded or closed."""
        with self._cond:
            while ci not in self._released:
                if self._stop or self._gen != gen:
                    return False, None
                self._cond.wait(0.05)
            return True, self._released[ci]

    def _q_put(self, item) -> bool:
        """Bounded put that stays responsive to stop and rewind (a plain
        blocking put could deadlock close() against a full queue)."""
        gen = item[0]
        while not self._stop and self._gen == gen:
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # ---- consumer ----
    def start_pass(self, gated=False):
        """Rewind to chunk 0 for a fresh in-order pass, discarding any
        staged blocks of a superseded pass. ``gated``: stage each chunk
        after the consumer's release of the one before (see above)."""
        with self._cond:
            self._released = {}
        with self._lock:
            self._gen += 1
            self._gated = bool(gated)
        while True:                      # drain stale blocks
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if not self._started:
            self._thread.start()
            self._started = True
        self._wake.set()

    def get(self, ci: int):
        """Chunk ``ci``'s staged block (strictly in-order consumption).
        Books a prefetch stall when the producer had not staged it
        yet."""
        t0 = None
        while True:
            try:
                gen, got, blk, err = self._q.get(timeout=0.05)
            except queue.Empty:
                if t0 is None:
                    t0 = _time.perf_counter()
                if self._stop or not self._thread.is_alive():
                    raise RuntimeError(
                        "stream prefetch thread is gone (closed or "
                        "crashed): no staged chunk to consume")
                continue
            if gen != self._gen:
                continue                 # stale pass, drop
            if err is not None:
                raise err
            if got != ci:
                raise RuntimeError(
                    f"stream pipeline out of order: wanted chunk {ci}, "
                    f"staged {got} (chunks must be consumed in order; "
                    "call start_pass() to rewind)")
            if t0 is not None:
                dt = _time.perf_counter() - t0
                obs.counter_add("stream.prefetch_stalls")
                obs.histogram_observe("stream.prefetch_stall_seconds", dt)
            return blk

    def release(self, ci: int, event=None):
        """The consumer is about to solve chunk ``ci`` (a gated pass):
        the producer may stage chunk ci + 1, its copy ordered after
        ``event`` (recorded on the consumer's stream; None on the
        CPU)."""
        with self._cond:
            self._released[ci] = event
            self._cond.notify_all()

    # ---- lifecycle ----
    @property
    def alive(self) -> bool:
        return self._started and self._thread.is_alive()

    def close(self):
        """Idempotent shutdown: stop the producer, drain, join."""
        self._stop = True
        self._wake.set()
        with self._cond:
            self._cond.notify_all()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._started:
            self._thread.join(timeout=5.0)


class H2DStager:
    """Host blocks -> device tensors for the producer thread: a ring of
    ``slots`` pinned buffer sets and one side stream on the card, plain
    copies on the CPU. ``stage(arrays)`` starts the copies of one chunk
    (a dict of host arrays) and returns the device tensors; ``record()``
    then closes the chunk with its event (None on the CPU)."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self.cuda \
            else None
        self._ring = [{} for _ in range(max(int(slots), 1))]
        self._events = [None] * len(self._ring)
        self._next = 0

    @property
    def stream(self):
        """The side stream (None on the CPU): device work that belongs
        to a staged chunk (dequantization) runs on it too."""
        return self._stream

    def stage(self, arrays: dict, after=None):
        """Start the copies of one chunk's host arrays; on the card the
        side stream first waits on ``after`` (a consumer event)."""
        if not self.cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(a))
                    for k, a in arrays.items()}
        slot = self._next
        self._next = (slot + 1) % len(self._ring)
        ev = self._events[slot]
        if ev is not None:
            # the slot's previous copy must have left its pinned buffers
            ev.synchronize()
        bufs = self._ring[slot]
        out = {}
        with torch.cuda.stream(self._stream):
            if after is not None:
                self._stream.wait_event(after)
            for k, a in arrays.items():
                a = np.ascontiguousarray(a)
                want = torch.from_numpy(a[:0]).dtype
                buf = bufs.get(k)
                if buf is None or tuple(buf.shape) != a.shape \
                        or buf.dtype != want:
                    buf = bufs[k] = torch.empty(a.shape, dtype=want,
                                                pin_memory=True)
                buf.numpy()[...] = a
                out[k] = buf.to(self.device, non_blocking=True)
        return out

    def record(self):
        """One event on the side stream after the chunk's work, and the
        ring slot just used keeps it (stage waits on it before reusing
        the slot's buffers)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        self._events[(self._next - 1) % len(self._ring)] = ev
        return ev


def adopt(block: dict, event, device=None):
    """Consumer side of a staged block: the current stream waits on the
    chunk's copy event (no host wait), and every device tensor is
    recorded onto the current stream so the allocator keeps its memory
    until the work queued on that stream is done."""
    if event is None:
        return block
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    for t in block.values():
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(cur)
    return block
