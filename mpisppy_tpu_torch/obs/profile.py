"""Measured roofline: analytic work counts per instrumented entry (the
port of the JAX package's obs/profile.py).

XLA's ``cost_analysis`` has no counterpart under PyTorch, so each
instrumented entry books FLOPs and bytes from an ANALYTIC MODEL OF THE
WORK: a function of the operand shapes and the steps actually run,
never of the implementation. The hand-written ADMM block, its plain
version and the reference backend therefore book the same count for
the same work, and a later redesign of a kernel cannot move the
yardstick. The models (``block_cost``, ``qp_cost``, ``elementwise``)
are floors: every operand read once per step, every product's
multiply-adds counted once, f64 unless the entry says otherwise.

Per call, :func:`call` books cumulative ``profile.flops`` /
``profile.hbm_bytes`` counters whose PER-ITERATION deltas
``core/ph.py`` records into each ``ph.iteration`` event; ``analyze``
joins those deltas against the iteration's seconds for measured MFU
and HBM-bandwidth utilization. The first sighting of an (entry, shape
bucket) emits one ``profile.entry`` event with the per-call counts,
keyed by a ``config_fingerprint`` of the bucket.

Entries whose exit is data-dependent (the adaptive ``qp.solve``) book
after the call returns, from the iteration count the solve already
read to the host to decide its exit: no booking adds a sync. Each call
also runs inside an ``obs.span`` of the entry's name, so a torch
profiler capture groups the call's kernels under it (obs/trace.py).

Timing: on a CUDA device a call is bracketed by two CUDA events,
recorded on the current stream (no sync), and read at the next
iteration record (``note_iteration``), which runs after the
iteration's gate has synced; on the CPU, where calls are synchronous,
by ``perf_counter``. The per-bucket totals land in the
``profile.bucket.device_seconds.<fingerprint>`` gauges.

There is no compile ledger to attribute: the port compiles no programs
at run time. ``analyze``'s ledger row reads a port run as zero
compiles on both sides (``ledger_matches`` holds).

Failures never propagate: a cost-model error books a
``profile.unavailable`` counter with a reasoned event (once per
entry/reason) and the call's result is returned as it is; a profile
failure never changes which implementation runs.
"""

from __future__ import annotations

import os
import threading
import time

from ..ckpt.bundle import config_fingerprint
from . import active as _active
from . import counter_add, event, gauge_set, span

# Peak device throughput table by device name substring: (peak FLOP/s
# at the engine's working precision, peak HBM GB/s). The H100 row is
# the H100 SXM data sheet's f64 tensor-core rate (67 TFLOP/s, the
# card's highest f64 rate) and HBM3 bandwidth (3.35 TB/s), the figures
# PERF.md §6 and chip_smoke.py's bounds use. The CPU tier gets a
# documented NOMINAL placeholder so CPU-tier MFU is finite (not a
# meaningful absolute utilization). Override either peak with
# MPISPPY_TPU_PEAK_FLOPS / MPISPPY_TPU_PEAK_HBM_GBPS.
_PEAKS_BY_KIND = (
    ("h100", 67e12, 3350.0),
    ("cpu", 1e11, 50.0),
)
_CPU_NOMINAL = (1e11, 50.0)


# ---------------- the analytic work models ----------------

def block_cost(S, m, n, n_steps, f_mats=1, itemsize=8):
    """(flops, bytes) of ``n_steps`` fixed-rho ADMM steps on S rows of
    a shared (m, n) A and ``f_mats`` (n, n) solve operators (1: the
    explicit inverse; 2: the L⁻¹ pair), then the residual tail.

    Per step: the products w·A, x̃·Aᵀ (2·S·m·n multiply-adds each) and
    the operator's (2·S·n² each); A and the operators are read once.
    The tail: x·Aᵀ and yA·A (4·S·m·n) over one pass of A. Vectors are
    left out (they are S/n of A's bytes)."""
    S, m, n, k, f = int(S), int(m), int(n), int(n_steps), int(f_mats)
    flops = k * 2 * S * (2 * m * n + f * n * n) + 4 * S * m * n
    nbytes = (k * (m * n + f * n * n) + m * n) * int(itemsize)
    return float(flops), float(nbytes)


def qp_cost(S, m, n, iters, check_every, *, shared=True, f_mats=1,
            ir_sweeps=0, itemsize=8):
    """(flops, bytes) of one ADMM solve of ``iters`` steps with a
    residual pass every ``check_every`` steps (at least one: the final
    residuals). Each step is ``block_cost``'s; a df32 step adds
    ``ir_sweeps`` refinement sweeps, each one more operator apply and
    one more A, Aᵀ pair. A per-scenario (S, m, n) A and operator are
    read in full (``shared=False``). ``block_cost(S, m, n, k)`` equals
    ``qp_cost(S, m, n, k, k)``: the same work books the same count."""
    S, m, n, k = int(S), int(m), int(n), int(iters)
    f, r = int(f_mats), int(ir_sweeps)
    passes = max(1, -(-k // max(int(check_every), 1)))
    rows = 1 if shared else S
    flops = k * 2 * S * (1 + r) * (2 * m * n + f * n * n) \
        + passes * 4 * S * m * n
    nbytes = (k * rows * (1 + r) * (m * n + f * n * n)
              + passes * rows * m * n) * int(itemsize)
    return float(flops), float(nbytes)


def elementwise(numel, reads, writes, flops_per=1, itemsize=8):
    """(flops, bytes) of an elementwise / reduction op over ``numel``
    elements: ``reads`` inputs and ``writes`` outputs of that size."""
    numel = int(numel)
    return (float(flops_per * numel),
            float((reads + writes) * numel * int(itemsize)))


# ---------------- per-session state ----------------

class _State:
    """Per-telemetry-session capture state. Reset whenever the
    process-wide Recorder changes (tests reconfigure sessions
    freely)."""

    __slots__ = ("rec", "lock", "costs", "failed", "seconds", "pending",
                 "totals", "device_emitted", "peaks", "last_iter")

    def __init__(self, rec):
        self.rec = rec
        self.lock = threading.Lock()
        self.costs = {}              # (entry, key) -> fingerprint
        self.failed = set()          # (entry, reason) emitted once
        self.seconds = {}            # fingerprint -> cumulative call s
        self.pending = []            # (fingerprint, start ev, end ev)
        self.totals = {}             # entry -> {calls, flops, bytes}
        self.device_emitted = False
        self.peaks = None            # (flops, gbps, source, kind)
        self.last_iter = {}          # plain dict: the signal-safe view


_STATE: _State | None = None
_STATE_LOCK = threading.Lock()


def _state() -> _State | None:
    """The capture state bound to the CURRENT telemetry session (None
    when telemetry is off)."""
    global _STATE
    rec = _active()
    if rec is None:
        return None
    s = _STATE
    if s is None or s.rec is not rec:
        with _STATE_LOCK:
            s = _STATE
            if s is None or s.rec is not rec:
                s = _STATE = _State(rec)
    return s


# ---------------- peaks ----------------

def _device_kind(device) -> str:
    try:
        import torch
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            return str(torch.cuda.get_device_name(dev))
        if dev is not None:
            return dev.type
    except Exception:
        pass
    return "unknown"


def _resolve_peaks(s: _State, device=None):
    """(peak_flops, peak_hbm_gbps, source, device_kind) — env override
    > device-name table > nominal CPU default — from the first
    instrumented call's device. Emits the one-shot ``profile.device``
    event so consumers (analyze, chip_smoke.py) read the resolved
    peaks from the stream."""
    if s.peaks is not None:
        return s.peaks
    kind = _device_kind(device)
    flops = gbps = None
    source = "table"
    lk = kind.lower()
    for sub, f, g in _PEAKS_BY_KIND:
        if sub in lk:
            flops, gbps = f, g
            break
    if flops is None:
        flops, gbps = _CPU_NOMINAL
        source = "default"
    env_f = os.environ.get("MPISPPY_TPU_PEAK_FLOPS")
    env_g = os.environ.get("MPISPPY_TPU_PEAK_HBM_GBPS")
    try:
        if env_f:
            flops = float(env_f)
            source = "env"
        if env_g:
            gbps = float(env_g)
            source = "env"
    except ValueError:
        pass
    s.peaks = (flops, gbps, source, kind)
    if not s.device_emitted:
        s.device_emitted = True
        event("profile.device", {
            "device_kind": kind, "peak_flops": flops,
            "peak_hbm_gbps": gbps, "source": source,
            "cpu_tier": "cpu" in lk or kind == "unknown"})
    return s.peaks


# ---------------- the instrumented call ----------------

def _unavailable(s, entry, reason):
    counter_add("profile.unavailable")
    if (entry, reason) not in s.failed:
        s.failed.add((entry, reason))
        event("profile.unavailable", {"entry": entry, "reason": reason})


def _clock_start(device):
    """A start mark: a CUDA event recorded on the current stream on a
    CUDA device (no sync), a perf_counter reading elsewhere."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ("cuda", ev, dev)
    return ("host", time.perf_counter(), None)


def _clock_stop(s, fp, mark):
    import torch
    kind, t0, dev = mark
    if kind == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        with s.lock:
            s.pending.append((fp, t0, ev))
        return
    _add_seconds(s, fp, time.perf_counter() - t0)


def _add_seconds(s, fp, dt):
    with s.lock:
        tot = s.seconds.get(fp, 0.0) + dt
        s.seconds[fp] = tot
    gauge_set(f"profile.bucket.device_seconds.{fp}", tot)


def settle():
    """Read the CUDA event pairs whose work has finished (``query``:
    no wait) into the per-bucket seconds. Called at the iteration
    record, after the iteration's gate synced."""
    s = _state()
    if s is None or not s.pending:
        return
    with s.lock:
        pending, s.pending = s.pending, []
    keep = []
    for fp, a, b in pending:
        if b.query():
            _add_seconds(s, fp, a.elapsed_time(b) / 1e3)
        else:
            keep.append((fp, a, b))
    if keep:
        with s.lock:
            s.pending = keep + s.pending


def call(entry, fn, cost, device=None):
    """Run ``fn()`` inside an ``entry`` span and book its work:
    ``cost(result)`` returns ``(key, flops, bytes)`` with ``key`` a
    hashable shape bucket (the operand shapes and step counts). Call
    sites guard with ``obs.enabled()`` — the disabled path never
    reaches here. Any booking failure degrades to the plain result."""
    s = _state()
    if s is None:
        return fn()
    try:
        mark = _clock_start(device)
    except Exception as e:
        _unavailable(s, entry, f"clock: {type(e).__name__}: {e}")
        mark = None
    with span(entry, cat="kernel"):
        out = fn()
    try:
        key, flops, nbytes = cost(out)
        _resolve_peaks(s, device)
        fp = s.costs.get((entry, key))
        if fp is None:
            fp = config_fingerprint({"entry": entry,
                                     "key": [str(k) for k in key]})
            with s.lock:
                s.costs[(entry, key)] = fp
            counter_add("profile.captures")
            event("profile.entry", {"entry": entry, "fingerprint": fp,
                                    "flops": flops,
                                    "bytes_accessed": nbytes,
                                    "model": "analytic"})
        counter_add("profile.flops", flops)
        counter_add("profile.hbm_bytes", nbytes)
        with s.lock:
            t = s.totals.setdefault(entry, {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
            t["calls"] += 1
            t["flops"] += flops
            t["bytes"] += nbytes
        if mark is not None:
            _clock_stop(s, fp, mark)
    except Exception as e:
        _unavailable(s, entry, f"cost: {type(e).__name__}: {e}")
    return out


def entry_totals() -> dict:
    """{entry: {"calls", "flops", "bytes"}} booked this session (a
    copy; {} when telemetry is off)."""
    s = _state()
    if s is None:
        return {}
    with s.lock:
        return {k: dict(v) for k, v in s.totals.items()}


# ---------------- the per-iteration plane ----------------

def note_iteration(it, seconds, flops_delta, hbm_delta):
    """Called by ``core/ph.py`` once per iteration with that
    iteration's counter deltas: computes the measured-roofline figures,
    sets the ``profile.iter.*`` gauges, and refreshes the plain-dict
    view :func:`last_iteration` (the hub live plane reads THAT — no
    locks). Returns the figures dict (JSON-ready) or None when nothing
    was instrumented."""
    s = _state()
    if s is None:
        return None
    settle()
    if not flops_delta and not hbm_delta:
        return None
    peak_f, peak_g, _src, _kind = _resolve_peaks(s)
    secs = float(seconds) if seconds else 0.0
    mfu = hbm_gbps = hbm_util = None
    if secs > 0.0:
        mfu = float(flops_delta) / secs / peak_f
        hbm_gbps = float(hbm_delta) / secs / 1e9
        hbm_util = hbm_gbps / peak_g if peak_g else None
    fig = {"iter": int(it), "seconds": secs,
           "flops_per_iter": float(flops_delta),
           "hbm_bytes_per_iter": float(hbm_delta),
           "mfu": mfu, "hbm_gbps": hbm_gbps, "hbm_util": hbm_util}
    if mfu is not None:
        gauge_set("profile.iter.mfu", mfu)
        gauge_set("profile.iter.hbm_gbps", hbm_gbps)
        if hbm_util is not None:
            gauge_set("profile.iter.hbm_util", hbm_util)
    # rebind, don't mutate: lock-free readers see either the old
    # complete dict or the new complete dict, never a half-update
    s.last_iter = fig
    return fig


def last_iteration():
    """The most recent iteration's roofline figures as a plain dict
    (None before the first instrumented iteration or when telemetry is
    off). One attribute read, no locks."""
    s = _STATE
    rec = _active()
    if s is None or rec is None or s.rec is not rec:
        return None
    return s.last_iter or None
