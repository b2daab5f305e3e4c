"""Shape-bucketed warm cache: one warm engine per request shape (the
port's copy of the JAX package's serve/cache.py).

A *bucket* is the build identity of a request: (model, structural
``model_kwargs``, scenario count, algo knobs, hub family) — everything
that determines tensor shapes, the kernel plans and the KKT structure,
and NOTHING that is per-request vector data (rhs, bounds, costs). Two
requests of one bucket differ only in the stacked scenario vectors, so
they share the engine, its kernel plans (``PHBase._kernel_plans``) and
its KKT factorizations (``PHBase._factors`` depend on (A, P, rho) only
— all bucket-determined).

The port's warm-bucket promise: the second request of a shape builds no
CUDA kernel (no new ``kernel.build`` event, ops/kernels/_build.py) and
sets up no factorization (no new factor build,
``PHBase.factor_builds``). The wheel stamp carries both deltas
(``kernel_builds_delta``, ``factor_builds_delta``) and their sum as
``xla_compiles_delta``, the JAX record's key; the tier-1 serve tests
assert all three are 0 for a warm request.

The cache stores the engine as an opaque object and never touches it —
installation of request data into a checked-out engine is the wheel
manager's job (:func:`mpisppy_tpu_torch.serve.manager.install_batch`).

Concurrency: a checked-out entry is *exclusively leased* — a second
same-bucket wheel either waits for the lease or (``wait=False``)
builds an unmanaged engine of its own (which re-pays the factorization
and the kernel plans). LRU eviction skips leased entries. Counters:
``serve.cache.hit`` / ``.miss`` / ``.evict``.
"""

from __future__ import annotations

import threading
import time

from .. import obs
from ..ckpt.bundle import config_fingerprint


def bucket_fingerprint(fields: dict) -> str:
    """Stable 16-hex bucket id over the build-identity fields (same
    hashing as checkpoint fingerprints — ckpt/bundle). The caller
    (serve/batch.bucket_key) decides WHICH fields are structural."""
    return config_fingerprint(fields)


class BucketEntry:
    """One warm bucket: the engine plus bookkeeping. ``engine`` is
    opaque here; the manager installs per-request data into it."""

    def __init__(self, key: str, engine, meta=None):
        self.key = key
        self.engine = engine
        self.meta = dict(meta or {})
        self.built_unix = time.time()
        self.last_used_unix = self.built_unix
        self.hits = 0
        self.wheels = 0
        self._lease = threading.Lock()

    @property
    def leased(self) -> bool:
        return self._lease.locked()

    def status(self) -> dict:
        return {"key": self.key, "hits": self.hits,
                "wheels": self.wheels, "leased": self.leased,
                "built_unix": self.built_unix,
                "last_used_unix": self.last_used_unix, **self.meta}


class WarmCache:
    """LRU over :class:`BucketEntry` keyed by bucket fingerprint.

    Protocol::

        ent = cache.checkout(key)          # None = miss (build one)
        if ent is None:
            ent = cache.admit(key, build_engine(), meta)
        try:
            ...                            # exclusive use of ent.engine
        finally:
            cache.checkin(ent)
    """

    def __init__(self, capacity: int = 8):
        self.capacity = max(1, int(capacity))
        self._entries: dict[str, BucketEntry] = {}   # insertion = LRU order
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def checkout(self, key: str, wait: bool = True,
                 timeout: float | None = None) -> BucketEntry | None:
        """Exclusive lease on the bucket's entry, or None on a miss
        (``serve.cache.miss`` booked; the caller builds and
        :meth:`admit`\\ s). A leased entry blocks until free unless
        ``wait=False`` (then: treated as a miss so the caller builds an
        unmanaged twin rather than queueing behind the lease)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._entries[key] = ent        # move to MRU
        if ent is None:
            obs.counter_add("serve.cache.miss")
            return None
        ok = ent._lease.acquire(blocking=wait,
                                **({} if timeout is None or not wait
                                   else {"timeout": timeout}))
        if not ok:
            obs.counter_add("serve.cache.miss")
            return None
        # re-validate under the lock: the lease may have been freed by
        # :meth:`discard` (torn wheel) or the entry LRU-evicted between
        # the lookup above and the acquire — leasing a dropped entry
        # would hand the next tenant exactly the untrustworthy engine
        # discard() exists to retire
        with self._lock:
            if self._entries.get(key) is not ent:
                ent._lease.release()
                obs.counter_add("serve.cache.miss")
                return None
        ent.hits += 1
        ent.last_used_unix = time.time()
        obs.counter_add("serve.cache.hit")
        return ent

    def admit(self, key: str, engine, meta=None) -> BucketEntry:
        """Register a freshly built engine under ``key`` and lease it
        to the caller. If another thread admitted the key first, the
        new engine stays UNMANAGED (used once by the worker that built
        it, then garbage) — exclusivity over; correctness first."""
        ent = BucketEntry(key, engine, meta)
        ent._lease.acquire()
        with self._lock:
            if key not in self._entries:
                self._entries[key] = ent
                self._evict_over_capacity_locked()
        return ent

    def checkin(self, ent: BucketEntry):
        """Release the exclusive lease taken by checkout/admit."""
        ent.wheels += 1
        ent.last_used_unix = time.time()
        ent._lease.release()

    def discard(self, ent: BucketEntry):
        """Drop a leased entry entirely (and release its lease): the
        wheel that held it raised, so the engine's state is not
        trustworthy — the next request of the bucket rebuilds cold
        instead of inheriting a torn install."""
        with self._lock:
            if self._entries.get(ent.key) is ent:
                del self._entries[ent.key]
                obs.counter_add("serve.cache.evict")
                obs.event("serve.cache_evict",
                          {"bucket": ent.key, "hits": ent.hits,
                           "wheels": ent.wheels, "discarded": True})
        ent._lease.release()

    def _evict_over_capacity_locked(self):
        # oldest-first; leased entries are skipped (their engine is in
        # the middle of a wheel) and re-considered on the next admit
        excess = len(self._entries) - self.capacity
        if excess <= 0:
            return
        for key in list(self._entries):
            if excess <= 0:
                break
            ent = self._entries[key]
            if ent.leased:
                continue
            del self._entries[key]
            excess -= 1
            obs.counter_add("serve.cache.evict")
            obs.event("serve.cache_evict",
                      {"bucket": key, "hits": ent.hits,
                       "wheels": ent.wheels})

    def status(self) -> dict:
        """JSON-ready view for /status and GET /queue."""
        with self._lock:
            return {"capacity": self.capacity,
                    "buckets": [e.status()
                                for e in self._entries.values()]}
