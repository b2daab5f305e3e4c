"""Process-wide metrics registry: counters, gauges, histograms.
(A copy of the JAX package's obs/metrics.py; the port keeps its own.)

The registry is deliberately tiny — a dict per kind under one lock —
because it sits on the PH hot loop's host path: a counter bump is a
dict ``get`` + add, a gauge a dict store, and a histogram a handful of
scalar updates plus one bisect into a FIXED edge table. Everything is
keyed by flat dotted names (``ph.gate_syncs``, ``qp.donated_passes``,
``hub.window_reads`` — see doc/observability.md for the catalog) so a
snapshot is directly JSON-serializable.

Counters are cumulative for the process lifetime: they deliberately
survive ``PHBase.reset_phase_timing`` (which zeroes the *wall-clock*
accumulators) so invariant tests can read "syncs per solve call" as a
pure counter ratio without monkeypatching engine internals.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Fixed log-spaced bucket edges for latency histograms: powers of two
# from ~1 µs to ~4096 s. Fixed (not adaptive) so two runs' snapshots
# are directly comparable bucket-for-bucket (`analyze --compare`), and
# so observe() costs one bisect into a shared tuple — no per-histogram
# allocation, no rebucketing. Span-duration observations land between
# sub-millisecond fused farmer phases and multi-minute reference-scale
# chunk solves, hence the wide range.
BUCKET_EDGES = tuple(2.0 ** e for e in range(-20, 13))


class Histogram:
    """Latency histogram: count/sum/min/max/last plus fixed-edge
    bucket counts, so ``snapshot()`` can report tail quantiles
    (p50/p95/p99) and not just means — a recovering chunk retry that
    doubles one iteration's gate time is invisible in a mean over 100
    iterations but owns the p99."""

    __slots__ = ("count", "sum", "min", "max", "last", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.last = None
        # buckets[i] counts observations in (BUCKET_EDGES[i-1],
        # BUCKET_EDGES[i]] — upper-INCLUSIVE, per-bucket counts (NOT
        # Prometheus-style cumulative); buckets[len(edges)] is the
        # +inf overflow bucket
        self.buckets = [0] * (len(BUCKET_EDGES) + 1)

    def observe(self, value: float):
        v = float(value)
        self.count += 1
        self.sum += v
        self.last = v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        # bisect_left: an exact-edge value lands in the bucket whose
        # UPPER edge it equals (upper-inclusive intervals)
        self.buckets[bisect_left(BUCKET_EDGES, v)] += 1

    def quantile(self, q: float):
        """Bucket-interpolated quantile in [0, 1]. Exact at the bucket
        boundaries, linear inside a bucket, clamped to observed
        min/max (so p50 of a single observation is that observation,
        not a bucket edge)."""
        if not self.count:
            return None
        rank = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            if n == 0:
                continue
            if seen + n >= rank:
                lo = 0.0 if i == 0 else BUCKET_EDGES[i - 1]
                hi = BUCKET_EDGES[i] if i < len(BUCKET_EDGES) \
                    else (self.max if self.max is not None else lo)
                frac = (rank - seen) / n
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += n
        return self.max

    def snapshot(self) -> dict:
        # keyed by upper edge; per-bucket counts, NOT cumulative (the
        # name says "upper edge", deliberately not Prometheus's
        # cumulative "le" convention)
        nonzero = {f"{BUCKET_EDGES[i]:g}" if i < len(BUCKET_EDGES)
                   else "+inf": n
                   for i, n in enumerate(self.buckets) if n}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "last": self.last,
                "mean": (self.sum / self.count) if self.count else None,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "buckets_upper_edge": nonzero}


class MetricsRegistry:
    """Counters, gauges, and histograms under one lock (hot-loop
    counter bumps can arrive from the spoke cylinder threads and the
    hub's iteration concurrently)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter_add(self, name: str, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge_set(self, name: str, value: float):
        with self._lock:
            self.gauges[name] = float(value)

    def histogram_observe(self, name: str, value: float):
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram()
            h.observe(value)

    def counters_snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def counter_get(self, name):
        with self._lock:
            return self.counters.get(name, 0)

    def histogram_get(self, name):
        """Snapshot of ONE histogram (None when it never observed) —
        the live status surface reads single tails without paying for
        a full registry snapshot."""
        with self._lock:
            h = self.histograms.get(name)
            return h.snapshot() if h is not None else None

    def snapshot(self, nonblocking=False):
        """JSON-ready snapshot of every metric. With ``nonblocking``
        (signal-handler context: the interrupted frame may HOLD the
        lock), returns None instead of deadlocking when the lock is
        unavailable."""
        if nonblocking:
            if not self._lock.acquire(blocking=False):
                return None
        else:
            self._lock.acquire()
        try:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self.histograms.items()},
            }
        finally:
            self._lock.release()
