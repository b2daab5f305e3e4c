"""Hub: the cylinder that owns the primary algorithm and brokers bounds.

Mirrors mpisppy/cylinders/hub.py:22-686: spoke classification by
``converger_spoke_types`` (ref. hub.py:245-283), best-bound bookkeeping
(:178-214), gap computation and rel/abs-gap termination (:72-137), the
screen trace table (:108-121), and the terminate signal = write-id -1 to
every spoke window (:356-368). PHHub pushes Ws + nonants and pulls bounds
each `sync()` (ref. hub.py:417-428).

The port's copy of the JAX package's cylinders/hub.py: engine state is
read through ``utils.runtime.to_host`` (it may live on the card), and
the live status plane (``status_port``, live.json) and checkpoints
(``checkpoint_dir``, ``resume_from``) raise, naming ROADMAP.md A13 and
A14, since their modules are not ported yet.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from .. import global_toc, obs
from ..utils.runtime import to_host
from .spcommunicator import SPCommunicator, Window, split_wire
from .spoke import ConvergerSpokeType


class Hub(SPCommunicator):
    def __init__(self, spbase_object, spokes=None, options=None):
        super().__init__(spbase_object, options)
        self.spokes = list(spokes or [])
        # best bounds for a MIN problem: outer = lower, inner = upper/incumbent
        self.BestOuterBound = -math.inf
        self.BestInnerBound = math.inf
        self._spoke_last_ids = [0] * len(self.spokes)
        self.latest_ib_char = " "
        self.latest_ob_char = " "
        self.gap_mark_times = {}
        # every best-bound improvement, stamped: (perf_counter, kind,
        # source char, value). perf_counter is MONOTONIC — NTP slews
        # and wall-clock jumps cannot reorder a merge — and
        # ``clock_anchor`` below pairs one perf_counter reading with
        # the wall clock so consumers (and the telemetry run header)
        # can convert. The benchmarks read this to evidence WHEN each
        # bound source first moved the needle (e.g. the first
        # non-trivial certified outer bound of a device-dual spoke vs
        # the iter-0 trivial seed) — bookkeeping only, no behavior.
        self.bound_events = []
        self.clock_anchor = {"wall_time_unix": time.time(),
                             "perf_counter": time.perf_counter()}
        # service-plane tag (mpisppy_tpu/serve): the wheel manager
        # stamps each hub with its request/group id so /status and the
        # event stream can attribute concurrent wheels to tenants
        self.request_tag = (options or {}).get("request_tag")
        sh = getattr(spbase_object, "_shard_ops", None)
        obs.event("hub.start", {"hub": type(self).__name__,
                                "request_tag": self.request_tag,
                                "spokes": len(self.spokes),
                                # engine sharding anatomy (analyze's
                                # sharding section reads this + the
                                # ph.iteration records)
                                "sharding": None if sh is None else
                                {"mode": "sharded",
                                 "n_devices": sh.n_devices,
                                 "shard_scenarios": sh.shard_size},
                                **self.clock_anchor})
        self._trivial_seed = None       # set when the hub seeds "T"
        self._print_rows = 0
        self.extra_checks = bool((options or {}).get("extra_checks", False))
        # supervision (cylinders/supervisor.py): the multi-process
        # launcher attaches a WheelSupervisor; the sync path polls it
        self.supervisor = None
        # wheel watchdog: "wheel_deadline" (seconds from hub start)
        # terminates a wheel that outlives it — checked on every
        # termination check, and (process wheels) fired from the
        # supervisor's timer thread even when the hub is stuck
        self._wheel_t0 = time.monotonic()
        self._watchdog_fired = False
        # the supervisor's timer thread and the hub thread can both
        # reach fire_watchdog — the once-guard must be atomic
        self._watchdog_lock = threading.Lock()
        self._reject_warned = set()     # spokes already WARNed about
        # ---- bound-flow lineage (doc/observability.md live plane) ----
        # per-spoke flow state, fed by _consume_window +
        # _book_flow_publish: produced = publishes the spoke stamped
        # (including ones the hub never read — the window overwrites in
        # place, so a missed publish shows up as a lineage-seq jump),
        # consumed = fresh publishes this hub actually read. Maintained
        # unconditionally (the /status endpoint and live.json need it
        # with telemetry off); metric booking is gated on
        # obs.enabled(). The lock covers hub-thread mutation vs
        # status-server HTTP-thread reads — a dict copy racing a
        # first-time reject-reason insert would raise mid-iteration
        # and 500 the scrape.
        self._flow_lock = threading.Lock()
        self._spoke_flow = [self._new_flow() for _ in self.spokes]
        # the live status plane (the JAX package's obs/live.py) and
        # durable checkpoints (its ckpt/) are not ported: asking for
        # either raises instead of running without it
        for opt, item in (("status_port", "A13"), ("checkpoint_dir", "A14"),
                          ("resume_from", "A14")):
            if self.options.get(opt) is not None:
                raise NotImplementedError(
                    f"hub option {opt!r} is not ported yet (see "
                    f"ROADMAP.md {item})")
        self.ckpt = None
        self._preempted = False
        self._preempt_lock = threading.Lock()

    @staticmethod
    def _new_flow():
        return {"last_seq": 0.0, "produced": 0, "consumed": 0,
                "accepted": 0, "rejected": 0, "rejects": {},
                "staleness_last": None, "gen": 0}

    # ---- topology (ref. hub.py:245-308 + spcommunicator.py:97) ----
    def classify_spokes(self):
        """Spoke classification by converger_spoke_types
        (ref. hub.py:245-283 initialize_spoke_indices)."""
        self.outer_bound_spoke_indices = set()
        self.inner_bound_spoke_indices = set()
        self.w_spoke_indices = set()
        self.nonant_spoke_indices = set()
        for i, sp in enumerate(self.spokes):
            ts = sp.converger_spoke_types
            if ConvergerSpokeType.OUTER_BOUND in ts:
                self.outer_bound_spoke_indices.add(i)
            if ConvergerSpokeType.INNER_BOUND in ts:
                self.inner_bound_spoke_indices.add(i)
            if ConvergerSpokeType.W_GETTER in ts:
                self.w_spoke_indices.add(i)
            if ConvergerSpokeType.NONANT_GETTER in ts:
                self.nonant_spoke_indices.add(i)

    def make_windows(self):
        """In-process (thread-cylinder) window wiring (the JAX
        package's multi-process wheels are ROADMAP.md A10)."""
        self.classify_spokes()
        for sp in self.spokes:
            sp.hub_window = Window(sp.remote_window_length())
            sp.my_window = Window(sp.local_window_length())
        self.windows_made = True

    # ---- bound bookkeeping (ref. hub.py:178-214) ----
    def _record_bound(self, kind, char, value):
        t = time.perf_counter()
        self.bound_events.append((t, kind, char, value))
        obs.counter_add("hub.bound_updates")
        obs.event("hub.bound", {"kind": kind, "char": char,
                                "value": value}, t=t)

    def OuterBoundUpdate(self, new_bound, char=" "):
        # refuse non-finite values outright: a single +inf here would
        # freeze compute_gaps at (inf, inf) for the rest of the run and
        # garble the final-bounds report. NaN is the quiet "no value
        # yet" convention (it loses every comparison anyway); ±inf is
        # corruption and gets flagged.
        if not math.isfinite(new_bound):
            if math.isinf(new_bound):
                self._reject_bound(None, "outer", char, new_bound,
                                   "nonfinite")
            return False
        if new_bound > self.BestOuterBound:
            self.BestOuterBound = new_bound
            self.latest_ob_char = char
            self._record_bound("outer", char, float(new_bound))
            return True
        return False

    def InnerBoundUpdate(self, new_bound, char=" "):
        if not math.isfinite(new_bound):
            if math.isinf(new_bound):
                self._reject_bound(None, "inner", char, new_bound,
                                   "nonfinite")
            return False
        if new_bound < self.BestInnerBound:
            self.BestInnerBound = new_bound
            self.latest_ib_char = char
            self._record_bound("inner", char, float(new_bound))
            return True
        return False

    # ---- ingest validation (the bound-poisoning firewall) ----
    def _crossed_tol(self, ref):
        """Tolerance for the crossed-bound corruption test: well above
        the ~2e-6 relative solve-noise crossings healthy wheels show,
        far below anything a genuinely corrupt payload lands at."""
        return float(self.options.get("crossed_bound_tol", 1e-4)) \
            * (1.0 + abs(ref))

    def _reject_bound(self, spoke, kind, char, value, reason):
        """Quarantine one payload instead of installing it: counted,
        evented, reported to the supervisor (enough rejections retire
        the spoke), never raised — a corrupt spoke must not crash the
        wheel it failed to poison.

        Per-READ accounting only: the quarantine policy deliberately
        counts every re-read of the same corrupt wire (heartbeat
        pulses included) — the per-PUBLISH flow ledger is settled once
        per fresh publish in :meth:`_book_flow_publish`, or one noisy
        crossed bound, re-pulsed for minutes, would drown the
        REJECTED-verdict ratio."""
        obs.counter_add("hub.bound_rejected")
        if reason == "crossed":
            obs.counter_add("hub.bound_crossed")
        if obs.enabled():
            # by-reason breakdown sums to hub.bound_rejected (both
            # count every read)
            obs.counter_add(f"hub.bound_rejected.{reason}")
        obs.event("hub.bound_rejected",
                  {"spoke": spoke, "kind": kind, "char": char,
                   "value": obs.finite_or_none(value), "reason": reason})
        if spoke not in self._reject_warned:
            self._reject_warned.add(spoke)
            global_toc(f"WARNING: rejected {reason} {kind} payload "
                       f"{value!r} from spoke {spoke} [{char}] "
                       "(further rejections counted silently)")
        # a crossed conflict proves SOME bound is corrupt but cannot
        # attribute which side (the resident bound may be the bad one)
        # — flag it, but only unambiguous garbage (non-finite,
        # implausible magnitude) counts toward quarantining the sender
        if spoke is not None and self.supervisor is not None \
                and reason != "crossed":
            self.supervisor.note_rejection(spoke)

    # ---- window consumption + bound-flow lineage ----
    def _consume_window(self, i, sp):
        """THE freshness-checked read of spoke ``i``'s window — the one
        body behind every hub read path (base bounds AND subclass cut
        traffic), so the write-id accounting and the per-spoke lineage
        bookkeeping cannot drift apart. Returns ``None`` when the
        window is stale or killed, else ``(payload, fresh)``: the
        SEMANTIC payload with the lineage suffix stripped, and whether
        this read carried a fresh publish (lineage seq advanced —
        False for idle heartbeat re-stamps, which only bump the
        write-id; True for lineage-less payloads, the legacy
        behavior)."""
        values, wid = sp.my_window.read()
        if wid == Window.KILL or wid <= self._spoke_last_ids[i]:
            return None
        self._spoke_last_ids[i] = wid
        obs.counter_add("hub.window_reads")
        payload, seq, _t_compute, t_publish = split_wire(values)
        flow = self._spoke_flow[i]
        if math.isnan(seq):
            # no lineage (startup hello, pre-lineage producer): consume
            # the payload, book nothing, treat it as a fresh publish
            return payload, True
        fresh = seq != flow["last_seq"]
        if fresh:
            # seq < last_seq means a respawned incarnation restarted
            # its counter: its `seq` publishes are all new to us
            step = seq - flow["last_seq"] if seq > flow["last_seq"] \
                else seq
            staleness = time.time() - t_publish
            with self._flow_lock:
                flow["produced"] += int(step)
                flow["consumed"] += 1
                flow["last_seq"] = seq
                flow["staleness_last"] = staleness
                produced, consumed = flow["produced"], flow["consumed"]
            if obs.enabled():
                obs.histogram_observe(
                    f"hub.spoke.staleness_seconds.spoke{i}", staleness)
                obs.gauge_set(f"hub.spoke.produced_writes.spoke{i}",
                              produced)
                obs.gauge_set(f"hub.spoke.consumed_writes.spoke{i}",
                              consumed)
                obs.gauge_set(f"hub.spoke.lag.spoke{i}",
                              produced - consumed)
        return payload, fresh

    def note_spoke_respawn(self, i, gen):
        """Supervisor hook: spoke ``i`` restarts as generation ``gen``
        on a fresh window pair — its publish seq restarts at 1, so the
        flow tracker must not mistake the first new publish for a
        replay (the seq<last_seq fallback in _consume_window also
        covers it; this makes the common path exact)."""
        if i < len(self._spoke_flow):
            with self._flow_lock:
                self._spoke_flow[i]["last_seq"] = 0.0
                self._spoke_flow[i]["gen"] = gen

    def _book_flow_publish(self, i, verdicts):
        """Settle ONE fresh publish into spoke ``i``'s flow ledger from
        its per-side ingest verdicts. A publish counts ACCEPTED when
        any side installed (a dual-typed spoke's healthy side keeps
        driving the gap — half-installed traffic must not read as
        quarantined), REJECTED only when no side installed and at
        least one was quarantined — so ``accepted + rejected`` counts
        distinct publishes, the ratio the bound-flow verdicts diagnose
        against. All-None (NaN startup hello) books nothing. Heartbeat
        re-reads never reach here (``fresh`` gating in the callers)."""
        verdicts = [v for v in verdicts if v is not None]
        if not verdicts or i is None or i >= len(self._spoke_flow):
            return
        accepted = any(v == "accepted" for v in verdicts)
        with self._flow_lock:
            flow = self._spoke_flow[i]
            if accepted:
                flow["accepted"] += 1
            else:
                reason = verdicts[0][1]
                flow["rejected"] += 1
                flow["rejects"][reason] = \
                    flow["rejects"].get(reason, 0) + 1
        if obs.enabled():
            obs.counter_add(f"hub.spoke.bounds_accepted.spoke{i}"
                            if accepted
                            else f"hub.spoke.bounds_rejected.spoke{i}")

    def _ingest_bound(self, i, sp, kind, value):
        """One validated bound install from spoke ``i``'s window.
        Returns the side's flow verdict — ``None`` ("no value yet":
        NaN hello / unset side of a dual window), ``"accepted"``, or
        ``("rejected", reason)`` — for the CALLER to settle into one
        per-publish ledger entry via :meth:`_book_flow_publish` (a
        dual-typed spoke ingests two sides per publish; booking here
        would double-count)."""
        v = float(value)
        if math.isnan(v):
            return None       # "no value yet" (startup hello / one side)
        char = sp.converger_spoke_char
        if math.isinf(v):
            self._reject_bound(i, kind, char, v, "nonfinite")
            return ("rejected", "nonfinite")
        # implausible magnitude: finite garbage (bit-corrupted doubles,
        # the injector's 'garbage' mode at ~1e30) would otherwise
        # install uncontested while the opposite side is still unset
        # and then poison the crossed-bound test against every
        # legitimate bound that follows. No real objective approaches
        # the default cap; models that legitimately do can raise it.
        if abs(v) > float(self.options.get("bound_magnitude_cap", 1e25)):
            self._reject_bound(i, kind, char, v, "implausible")
            return ("rejected", "implausible")
        # crossed-bound corruption: in a MIN problem a true outer bound
        # can never sit above a feasible inner bound (beyond noise)
        if kind == "outer" and math.isfinite(self.BestInnerBound) \
                and v > self.BestInnerBound \
                + self._crossed_tol(self.BestInnerBound):
            self._reject_bound(i, kind, char, v, "crossed")
            return ("rejected", "crossed")
        if kind == "inner" and math.isfinite(self.BestOuterBound) \
                and v < self.BestOuterBound \
                - self._crossed_tol(self.BestOuterBound):
            self._reject_bound(i, kind, char, v, "crossed")
            return ("rejected", "crossed")
        # passed validation: an ACCEPTED side (whether or not it
        # improves the best bound — a spoke republishing a
        # non-improving bound is healthy traffic)
        if kind == "outer":
            self.OuterBoundUpdate(v, char)
        else:
            self.InnerBoundUpdate(v, char)
        return "accepted"

    def first_nontrivial_outer_time(self):
        """perf_counter stamp of the first outer-bound improvement that
        came from a real bound source (not the "T" trivial seed) AND
        beat the trivial bound by more than float/solver noise — the
        moment the wheel's outer bound stopped being the iter-0
        wait-and-see value. None until the trivial seed is known (a
        spoke's own W=0 prep bound is the SAME wait-and-see quantity
        computed by an independent engine; without the seed to compare
        against, stamping it would satisfy 'non-trivial' on solver
        jitter alone) and until a genuinely better bound lands."""
        triv = self._trivial_seed
        if triv is None:
            return None
        # 2e-4 relative: ABOVE the ~1e-7..1e-4 independent-solve jitter
        # two engines can show on the same W=0 wait-and-see bound
        # (loose duals on degenerate LPs), far BELOW the percent-level
        # movement a real W-step improvement delivers — so the stamp
        # cannot be satisfied by jitter, only by a genuine bound step
        margin = 2e-4 * (1.0 + abs(triv))
        for t, kind, char, val in self.bound_events:
            if kind == "outer" and char != "T" and val > triv + margin:
                return t
        return None

    def receive_bounds(self):
        """Read every bound spoke's window; freshness via write-id
        (ref. hub.py:333-354). Only spokes this loop actually CONSUMES
        advance their last-seen id — a non-bound window (e.g. a cut
        spoke's, consumed by a subclass) must not be marked read here, or
        a payload written between the subclass's read and this one is
        silently lost. A spoke typed BOTH outer and inner (the EF-MIP
        spoke: one B&B yields dual bound AND incumbent) publishes a
        2-value window [outer, inner]; NaN entries mean "no value yet"
        and lose every bound comparison harmlessly.

        Every payload passes ingest validation (_ingest_bound): ±inf
        and crossed bounds are quarantined — counted and evented, never
        installed (doc/fault_tolerance.md). The supervisor, when one is
        attached, is polled here too: the sync path IS the wheel's
        liveness beat."""
        if self.supervisor is not None:
            self.supervisor.poll()
        for i, sp in enumerate(self.spokes):
            is_outer = i in self.outer_bound_spoke_indices
            is_inner = i in self.inner_bound_spoke_indices
            if not is_outer and not is_inner:
                continue
            res = self._consume_window(i, sp)
            if res is None:
                continue
            values, fresh = res
            verdicts = []
            if is_outer:
                verdicts.append(
                    self._ingest_bound(i, sp, "outer", values[0]))
            if is_inner:
                verdicts.append(self._ingest_bound(
                    i, sp, "inner",
                    values[1] if is_outer else values[0]))
            if fresh:
                # one ledger entry per publish, however many sides it
                # carried (heartbeat re-reads re-ingest above for the
                # quarantine policy but never book)
                self._book_flow_publish(i, verdicts)

    # ---- gap + termination (ref. hub.py:72-137) ----
    def compute_gaps(self):
        if not (math.isfinite(self.BestInnerBound)
                and math.isfinite(self.BestOuterBound)):
            return math.inf, math.inf
        abs_gap = self.BestInnerBound - self.BestOuterBound
        nano = abs(self.BestInnerBound)
        rel_gap = abs_gap / nano if nano > 1e-10 else math.inf
        return abs_gap, rel_gap

    # ---- the live plane (obs/live.py, doc/observability.md) ----
    def bound_flow_status(self):
        """Per-spoke bound-flow ledger: publishes produced vs consumed,
        accept/reject verdicts, staleness. The one source behind
        /status, live.json, the bench ``bound_flow`` block, and (after
        the run, via the booked metrics) analyze's bound-flow section."""
        out = {}
        for i, f in enumerate(self._spoke_flow):
            with self._flow_lock:   # vs hub-thread ledger mutation
                ent = {"char": getattr(self.spokes[i],
                                       "converger_spoke_char", "?"),
                       "produced": f["produced"],
                       "consumed": f["consumed"],
                       "lag": f["produced"] - f["consumed"],
                       "accepted": f["accepted"],
                       "rejected": f["rejected"],
                       "rejects_by_reason": dict(f["rejects"]),
                       "staleness_last_seconds": f["staleness_last"]}
            h = obs.histogram_snapshot(
                f"hub.spoke.staleness_seconds.spoke{i}")
            if h is not None:
                ent["staleness_p50_seconds"] = h.get("p50")
                ent["staleness_p99_seconds"] = h.get("p99")
            out[f"spoke{i}"] = ent
        return out

    # ---- wheel watchdog (doc/fault_tolerance.md) ----
    def fire_watchdog(self, source):
        """Deadline exceeded: terminate the wheel CLEANLY — kill signal
        to every spoke, telemetry flushed, partial bounds evented (the
        wheel-level analog of bench.py's SIGTERM flush). Once-guarded;
        callable from the supervisor's timer thread."""
        with self._watchdog_lock:
            if self._watchdog_fired:
                return
            self._watchdog_fired = True
        fin = obs.finite_or_none
        elapsed = time.monotonic() - self._wheel_t0
        obs.counter_add("hub.watchdog_fired")
        obs.event("hub.watchdog_fired",
                  {"source": source, "elapsed": elapsed,
                   "outer": fin(self.BestOuterBound),
                   "inner": fin(self.BestInnerBound)})
        global_toc(f"WARNING: wheel watchdog fired after {elapsed:.1f}s "
                   f"({source}); terminating with partial bounds "
                   f"outer {self.BestOuterBound:.6g} / inner "
                   f"{self.BestInnerBound:.6g}")
        # a watchdog kill is a premature end: capture the state it
        # would otherwise lose (forced — the interval must not skip
        # the last chance)
        # nonblocking: the timer thread may interrupt a frame holding a
        # sink lock (the same contract as bench's signal-handler flush)
        obs.flush(nonblocking=True)
        self.send_terminate()

    def handle_preemption(self, source="sigterm"):
        """The preemption notice path (SIGTERM on a preemptible pod —
        utils/multiproc installs the handler when checkpointing is
        armed, the wheel-level analog of bench.py's signal-safe
        flush): force one final checkpoint bundle, flush telemetry
        nonblocking, signal the spokes, and mark the wheel terminated
        so the hub loop exits at its next check. Once-guarded; safe
        from a signal frame (main thread) interrupting the hub loop."""
        with self._preempt_lock:
            if self._preempted:
                return
            self._preempted = True
        fin = obs.finite_or_none
        obs.counter_add("hub.preempted")
        obs.event("hub.preempted",
                  {"source": source,
                   "iter": getattr(self.opt, "_iter", None),
                   "outer": fin(self.BestOuterBound),
                   "inner": fin(self.BestInnerBound)})
        global_toc(f"WARNING: preemption notice ({source}); "
                   "checkpointing and terminating")
        # NOTE: a streamed engine's prefetch thread is NOT closed here
        # — the signal frame interrupts the hub loop mid-iteration and
        # the in-flight chunk pass still consumes staged blocks; the
        # orderly close happens in hub_finalize (which the preempted
        # loop reaches on its next termination check), and the thread
        # is a daemon besides, so even a rough exit cannot hang on it.
        obs.flush(nonblocking=True)
        self.send_terminate()

    def _wheel_deadline_exceeded(self) -> bool:
        if self._watchdog_fired:
            return True
        deadline = self.options.get("wheel_deadline")
        if deadline is not None \
                and time.monotonic() - self._wheel_t0 > float(deadline):
            self.fire_watchdog("hub")
            return True
        return False

    def determine_termination(self) -> bool:
        if self._preempted:
            return True
        if self._wheel_deadline_exceeded():
            return True
        abs_gap, rel_gap = self.compute_gaps()
        if obs.enabled():
            # the hub half of the per-iteration convergence record
            # (ph.iteration is the engine half): bounds + gap as the
            # wheel sees them EVERY termination check, not only when a
            # bound moved (hub.screen_row) — analyze reads the pair to
            # draw one trajectory per run
            fin = obs.finite_or_none
            obs.event("hub.iteration",
                      {"iter": getattr(self.opt, "_iter", None),
                       "outer": fin(self.BestOuterBound),
                       "inner": fin(self.BestInnerBound),
                       "abs_gap": fin(abs_gap), "rel_gap": fin(rel_gap),
                       # bound-flow time series: produced vs consumed
                       # per spoke at every check — analyze's
                       # silent-starvation invariant reads exactly this
                       # (produced advancing while consumed stays flat)
                       "flow": {f"spoke{i}": {"produced": f["produced"],
                                              "consumed": f["consumed"]}
                                for i, f in enumerate(self._spoke_flow)}
                       if self._spoke_flow else None})
        # rel-gap milestone stamps: the "gap_marks" hub option lists
        # thresholds whose first crossing instant is recorded in
        # self.gap_mark_times (time-to-gap benchmarks read these;
        # perf_counter, not wall time) without affecting termination
        for mark in self.options.get("gap_marks", ()):
            if rel_gap <= mark and mark not in self.gap_mark_times:
                self.gap_mark_times[mark] = time.perf_counter()
                obs.event("hub.gap_mark",
                          {"mark": mark, "rel_gap": rel_gap},
                          t=self.gap_mark_times[mark])
        abs_opt = self.options.get("abs_gap", None)
        rel_opt = self.options.get("rel_gap", None)
        return (abs_opt is not None and abs_gap <= abs_opt) or \
            (rel_opt is not None and rel_gap <= rel_opt)

    def screen_trace(self, it):
        # print a row only when a bound moved (ref. hub.py:108-121)
        state = (self.BestOuterBound, self.BestInnerBound)
        if getattr(self, "_last_printed", None) == state:
            return
        self._last_printed = state
        if obs.enabled():
            ag, rg = self.compute_gaps()
            fin = obs.finite_or_none
            obs.event("hub.screen_row",
                      {"iter": it, "outer": fin(self.BestOuterBound),
                       "inner": fin(self.BestInnerBound),
                       "abs_gap": fin(ag), "rel_gap": fin(rg),
                       "ob_char": self.latest_ob_char,
                       "ib_char": self.latest_ib_char})
        if self._print_rows % 20 == 0:
            global_toc(f"{'Iter.':>5s}  {'Best Bound':>15s}  "
                       f"{'Best Incumbent':>15s}  {'Rel. Gap':>9s}  "
                       f"{'Abs. Gap':>12s}")
        abs_gap, rel_gap = self.compute_gaps()
        rg = f"{100 * rel_gap:8.3f}%" if math.isfinite(rel_gap) else "   inf  "
        global_toc(f"{it:5d} {self.latest_ob_char}{self.BestOuterBound:15.4f}  "
                   f"{self.latest_ib_char}{self.BestInnerBound:14.4f}  {rg}  "
                   f"{abs_gap:12.4f}")
        self._print_rows += 1

    def send_terminate(self):
        """Write-id -1 into every hub-owned window (ref. hub.py:356-368)."""
        obs.event("hub.terminate", {"spokes": len(self.spokes)})
        for sp in self.spokes:
            sp.hub_window.kill()

    def hub_finalize(self):
        self.receive_bounds()
        # one last durable bundle so a relaunch resumes from the FINAL
        # state (also covers watchdog/preempt wheels whose forced
        # capture preceded the last spoke bounds)
        abs_gap, rel_gap = self.compute_gaps()
        global_toc(f"Final bounds: outer {self.BestOuterBound:.4f} / inner "
                   f"{self.BestInnerBound:.4f}, rel gap "
                   f"{100 * rel_gap:.4f}%")
        # streamed engines: stop the prefetch thread with the wheel
        # (idempotent; a serve-leased engine re-binds on its next pass)
        cs = getattr(self.opt, "close_stream", None)
        if callable(cs):
            cs()
        return self.BestOuterBound, self.BestInnerBound

    def shutdown_live(self):
        """Release the live status plane (the launchers call this on
        their exception paths); the port has none to release."""

    def main(self):
        raise NotImplementedError


def hub_blocks(opt):
    """The hub engine's (W, nonants) as host (S_orig, K) arrays. A
    SHARDED engine's blocks are every rank's rows, assembled by two
    zero-buffer all-reduces (parallel/mesh.Mesh.gather_rows) in which
    every rank of the mesh takes part: rank 0's PHHub.sync and the
    other ranks' MeshFollower.sync both call this, in this order. The
    cylinder wire format carries the REAL scenarios only (spokes run
    unpadded engines and size their windows from the true S)."""
    S = getattr(opt, "_S_orig", None)
    gather = getattr(opt, "gather_rows", lambda t: t)
    W = to_host(gather(opt.W), np.float64)[:S]
    X = to_host(gather(opt._hub_nonants()), np.float64)[:S]
    return W, X


def _share_stop(opt, stop, outer):
    """Rank 0's stop decision and best outer bound, broadcast over the
    engine's mesh (the one broadcast of an iteration; identity without
    a sharded mesh). Returns (stop, outer) as every rank holds them."""
    mesh = getattr(opt, "shard_mesh", None)
    if mesh is None:
        return stop, outer
    import torch
    v = mesh.broadcast(torch.tensor([float(bool(stop)), float(outer)],
                                    dtype=torch.float64,
                                    device=mesh.device))
    v = v.cpu().tolist()
    return bool(v[0]), v[1]


class MeshFollower:
    """The hub side of a wheel on ranks 1.. of a sharded hub engine:
    rank 0 runs the cylinders and the spokes' threads, the other ranks
    run only the hub engine's loop, whose ``spcomm`` this is. Each
    iteration it joins rank 0's collectives in PHHub.sync's order (the
    W and nonant gathers of ``hub_blocks``) and takes rank 0's stop
    decision and outer bound from its broadcast, so every rank leaves
    the loop at the same iteration and none is left in a collective."""

    def __init__(self, opt):
        self.opt = opt
        self.BestOuterBound = -math.inf

    def sync(self):
        hub_blocks(self.opt)

    def is_converged(self) -> bool:
        stop, outer = _share_stop(self.opt, False, -math.inf)
        self.BestOuterBound = outer
        self.opt.update_best_bound(outer)
        return stop


class PHHub(Hub):
    """PH as the hub algorithm (ref. hub.py:371-508). Over a sharded
    engine this hub runs on rank 0 (see MeshFollower)."""

    def setup_hub(self):
        assert self.windows_made

    @staticmethod
    def follower_main(opt):
        """The hub engine's loop on a follower rank of a mesh."""
        opt.ph_main(finalize=False)

    def _hub_arrays(self):
        """(W_flat, X_flat) the spokes should see — the ONE overridable
        source (APHShardHub substitutes Synchronizer-gathered full
        arrays; the push layout below stays shared)."""
        W, X = hub_blocks(self.opt)
        return W.reshape(-1), X.reshape(-1)

    def send_ws(self, X=None, W=None):
        if W is None:
            W = self._hub_arrays()[0]
        for i in self.w_spoke_indices:
            sp = self.spokes[i]
            has_w, has_x = sp.hub_read_layout()
            sp.hub_window.put(np.concatenate([W, X]) if has_x else W)

    def send_nonants(self, X):
        for i in self.nonant_spoke_indices - self.w_spoke_indices:
            self.spokes[i].hub_window.put(X)

    def sync(self):
        """Called from inside the PH iteration (ref. phbase.py:1522)."""
        W, X = self._hub_arrays()
        self.send_ws(X, W=W)
        self.send_nonants(X)
        self.receive_bounds()

    def is_converged(self) -> bool:
        # at iter 1 seed the outer bound with PH's trivial bound
        # (ref. hub.py:433-461)
        if self.opt._iter <= 1 and getattr(self.opt, "trivial_bound", None) is not None:
            if self._trivial_seed is None:
                self._trivial_seed = float(self.opt.trivial_bound)
            self.OuterBoundUpdate(self.opt.trivial_bound, "T")
        self.screen_trace(self.opt._iter)
        stop, _ = _share_stop(self.opt, self.determine_termination(),
                              self.BestOuterBound)
        return stop

    def main(self):
        self.opt.ph_main(finalize=False)


class CrossScenarioHub(PHHub):
    """PHHub + cut traffic: ships nonants to the cut spoke (via the normal
    NONANT_GETTER path) and installs received Benders rows on the engine
    (ref. mpisppy/cylinders/cross_scen_hub.py:11-160). The engine must be a
    ``CrossScenarioPH``."""

    def setup_hub(self):
        super().setup_hub()
        # attribute-based classification: multi-process wheels hand the
        # hub SpokeProxy objects, never real spoke instances
        self.cut_spoke_indices = {i for i, sp in enumerate(self.spokes)
                                  if getattr(sp, "is_cut_spoke", False)}

    def receive_bounds(self):
        # wire format carries REAL scenarios (see _hub_arrays)
        S, K = getattr(self.opt, "_S_orig", self.opt.batch.S), \
            self.opt.batch.K
        for i in self.cut_spoke_indices:
            sp = self.spokes[i]
            res = self._consume_window(i, sp)
            if res is None:
                continue
            values, fresh = res
            if np.isnan(values).all():
                # a process spoke's startup hello (all-NaN payload) —
                # consumed for readiness, never installed as cuts
                continue
            if not np.isfinite(values).all():
                # cut rows get the same ingest treatment as bounds: a
                # non-finite coefficient would poison the engine's cut
                # store — quarantine the payload, keep the wheel
                self._reject_bound(i, "cuts", sp.converger_spoke_char,
                                   None, "row_nonfinite")
                if fresh:
                    self._book_flow_publish(
                        i, [("rejected", "row_nonfinite")])
                continue
            rows = values.reshape(S, 1 + K)
            self.opt.add_cuts(rows[:, 0], rows[:, 1:])
            if fresh:
                self._book_flow_publish(i, ["accepted"])
        super().receive_bounds()


class APHHub(PHHub):
    """APH as the hub algorithm (ref. hub.py:606-686)."""

    @staticmethod
    def follower_main(opt):
        opt.APH_main(finalize=False)

    def main(self):
        self.opt.APH_main(finalize=False)


class APHShardHub(PHHub):
    """Wheel communicator carried by SHARD 0 of a scenario-sharded APH
    (core/aph_shard.py spin_aph_shard_wheel) — the analog of the
    reference's APHHub under mpiexec (ref. mpisppy/cylinders/hub.py:606
    APHHub), where hub ranks hold scenario subsets and the cylinder
    windows carry global arrays. The shard engine holds only its local
    scenarios; the FULL (W, nonant) block arrives through the async
    Synchronizer's "WX" reduction (disjoint per-shard rows, so the sum
    is an exact gather, stale for other shards by at most a listener
    beat — the same tolerated staleness as every APH reduction) and is
    staged on the engine as ``wheel_W`` / ``wheel_X`` before sync()."""

    def _hub_arrays(self):
        return (np.asarray(self.opt.wheel_W, np.float64).reshape(-1),
                np.asarray(self.opt.wheel_X, np.float64).reshape(-1))

    def main(self):
        raise RuntimeError("APHShardHub is driven by the shard worker's "
                           "APH loop (core/aph_shard.py), not main()")


class LShapedHub(Hub):
    """L-shaped as the hub: nonants-only pushes, bound from the master
    (ref. hub.py:511-603)."""

    def setup_hub(self):
        assert self.windows_made

    def sync(self, send_nonants=True):
        if send_nonants:
            X = to_host(self.opt._hub_nonants(),
                        np.float64)[:getattr(self.opt, "_S_orig",
                                             None)].reshape(-1)
            for i in self.nonant_spoke_indices:
                self.spokes[i].hub_window.put(X)
        self.receive_bounds()

    def is_converged(self) -> bool:
        bound = getattr(self.opt, "_LShaped_bound", None)
        if bound is not None:
            self.OuterBoundUpdate(bound, "B")
        # the master's x is evaluated against all subproblems every
        # iteration, so the engine's own incumbent is a valid inner bound
        ub = getattr(self.opt, "best_ub", None)
        if ub is not None and math.isfinite(ub):
            self.InnerBoundUpdate(ub, "B")
        self.screen_trace(self.opt._iter)
        return self.determine_termination()

    def main(self):
        self.opt.lshaped_algorithm(finalize=False)
