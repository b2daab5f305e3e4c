"""The wheel diagnosis engine: symptom → verdict rules over the
forensic samples (jax-free).
(A copy of the JAX package's obs/diagnose.py; the port keeps its own.)

``ops/forensics.py`` produces per-sample attribution stats (top
disagreeing slots, scenario residual shares, W-oscillation, rho
health); the hub's termination check contributes the outer/inner bound
trajectory. This module turns both streams into NAMED, evidence-
carrying verdicts — the answer to "why is the wheel stuck", not
another scalar:

- ``STALLED_OUTER(spoke=lagrangian, bound flat N checks)`` — the
  outer-bound spoke stopped improving while a real gap remains.
- ``OSCILLATING(slots=[...], advice: rho up)`` — W sign-flips
  persist on specific slots: the consensus is bouncing, not closing.
- ``CULPRIT_SCENARIOS([ids], residual share ≥ x%)`` — a few
  scenarios carry most of the primal residual mass.
- ``FIXING_STALL(bucket 0.25 never crossed)`` — progressive
  shrinking armed but the first fixed-fraction bucket never arrived.
- ``HEALTHY`` — none of the above fired.

Two consumption modes share ONE set of pure rule functions
(:func:`diagnose` and the ``rule_*`` helpers take plain lists/dicts):
the LIVE engine below (session-bound state in the ``obs/profile.py``
mold — identity-checked against the active Recorder, rebind-don't-
mutate snapshots so signal handlers and the hub status thread read
without locks), and ``obs/analyze.py``'s post-mortem re-diagnosis over
the recorded event streams. Emits ``forensics.*`` counters/gauges and
the ``forensics.verdict`` transition event (doc/forensics.md has the
full rule table).

jax-free by contract (lint rule PURE001): the hub status plane, the
bench signal handler, and serve read :func:`snapshot` as plain dict
lookups.
"""

from __future__ import annotations

import threading

from . import active as _active
from . import counter_add, event, gauge_set

# post-mortem spoke attribution: converger_spoke_char → the spoke kind
# string the CLI roles use (live runs resolve kinds straight from the
# supervisor; analyze maps the last screen_row's ob_char through this)
SPOKE_CHARS = {
    "L": "lagrangian", "A": "lagranger", "X": "xhatshuffle",
    "D": "xhatdive", "E": "ef", "F": "fwph", "S": "slam",
    "C": "cross_scenario",
}

# rule thresholds (one table so analyze's re-diagnosis and the live
# engine agree; doc/forensics.md documents every knob)
DEFAULTS = {
    "stall_checks": 5,       # consecutive flat outer-bound checks
    "stall_rel_tol": 1e-8,   # flatness tolerance, relative to |outer|
    "stall_gap_floor": 1e-4, # rel gap below this = effectively done
    "osc_mean_thresh": 0.25, # mean slot flip-EMA
    "osc_slot_thresh": 0.5,  # single-slot flip-EMA
    "osc_min_samples": 3,    # flip EMA needs two deltas to be real
    "culprit_share": 0.5,    # residual concentration threshold
    "culprit_max_frac": 0.25,  # ...carried by ≤ this fraction of scens
    "fixing_stall_iters": 25,  # iterations before a bucket is overdue
}

_SEVERITY = {"STALLED_OUTER": 3, "OSCILLATING": 2,
             "CULPRIT_SCENARIOS": 2, "FIXING_STALL": 1}


def _cfg(cfg):
    if not cfg:
        return DEFAULTS
    out = dict(DEFAULTS)
    out.update(cfg)
    return out


# ---------------- the pure rules ----------------

def rule_stalled_outer(bound_checks, cfg=None):
    """Outer bound flat across ≥ ``stall_checks`` consecutive checks
    while the rel gap stays above ``stall_gap_floor``. ``bound_checks``
    is a list of ``{"it", "outer", "inner", "rel_gap", "spoke"}`` in
    check order (``spoke`` = the kind that produced the current outer
    bound, None when unknown)."""
    c = _cfg(cfg)
    checks = [b for b in bound_checks
              if isinstance(b.get("outer"), (int, float))]
    if len(checks) < c["stall_checks"]:
        return None
    last = checks[-1]
    anchor = last["outer"]
    tol = c["stall_rel_tol"] * max(1.0, abs(anchor))
    flat = 0
    for b in reversed(checks):
        if abs(b["outer"] - anchor) > tol:
            break
        flat += 1
    gap = last.get("rel_gap")
    if flat < c["stall_checks"] or not isinstance(gap, (int, float)) \
            or gap <= c["stall_gap_floor"]:
        return None
    spoke = next((b.get("spoke") for b in reversed(checks)
                  if b.get("spoke")), None)
    return {
        "verdict": "STALLED_OUTER",
        "severity": _SEVERITY["STALLED_OUTER"],
        "summary": f"outer bound flat {flat} checks at {anchor:g} "
                   f"while rel gap {gap:.3g}"
                   + (f" (spoke={spoke})" if spoke else ""),
        "evidence": {"spoke": spoke, "flat_checks": flat,
                     "outer": anchor, "rel_gap": gap,
                     "it": last.get("it")},
        "advice": "the outer-bound spoke stopped improving — check "
                  "its subproblem budget, dual step, or rho scale",
    }


def rule_oscillating(samples, cfg=None):
    """Persistent W sign-flips: the last sample's flip-EMA exceeds the
    threshold on average or on specific slots. ``samples`` is a list
    of ``ops.forensics.unpack`` dicts in sample order."""
    c = _cfg(cfg)
    if not samples:
        return None
    fx = samples[-1]
    if fx.get("samples", 0) < c["osc_min_samples"]:
        return None
    slots = [int(sid) for sid, v in fx.get("osc_slots", ())
             if v >= c["osc_slot_thresh"]]
    mean = fx.get("osc_mean") or 0.0
    if mean < c["osc_mean_thresh"] and not slots:
        return None
    return {
        "verdict": "OSCILLATING",
        "severity": _SEVERITY["OSCILLATING"],
        "summary": f"W sign-flip EMA {mean:.2f}"
                   + (f", slots {slots}" if slots else ""),
        "evidence": {"slots": slots, "osc_mean": mean,
                     "it": fx.get("it")},
        "advice": "rho up",
    }


def rule_culprit_scenarios(samples, cfg=None):
    """Residual concentration: the smallest scenario set carrying
    ``culprit_share`` of the primal residual is at most
    ``culprit_max_frac`` of the real scenarios."""
    c = _cfg(cfg)
    if not samples:
        return None
    fx = samples[-1]
    shares = fx.get("scen_pri_shares") or []
    n = fx.get("n_scens") or len(shares)
    if n < 4 or not shares:
        return None       # concentration is meaningless on tiny S
    cum, ids = 0.0, []
    for sid, share in shares:
        cum += share
        ids.append(int(sid))
        if cum >= c["culprit_share"]:
            break
    if cum < c["culprit_share"] or len(ids) > max(1, int(
            n * c["culprit_max_frac"])):
        return None
    return {
        "verdict": "CULPRIT_SCENARIOS",
        "severity": _SEVERITY["CULPRIT_SCENARIOS"],
        "summary": f"scenarios {ids} carry {cum:.0%} of the primal "
                   f"residual ({len(ids)}/{n})",
        "evidence": {"ids": ids, "share": cum, "n_scens": n,
                     "it": fx.get("it")},
        "advice": "inspect those scenarios' subproblems (bounds, "
                  "conditioning) or rebalance their rho rows",
    }


def rule_fixing_stall(shrink, it, cfg=None):
    """Progressive shrinking armed but the first fixed-fraction bucket
    was never crossed after ``fixing_stall_iters`` iterations.
    ``shrink`` is the engine's plain shrink-status dict plus a
    ``"first_bucket"`` key."""
    c = _cfg(cfg)
    if not shrink or not isinstance(it, (int, float)) \
            or it < c["fixing_stall_iters"] \
            or shrink.get("compactions", 0) > 0:
        return None
    bucket = shrink.get("first_bucket")
    fixed = shrink.get("fixed", 0)
    free = shrink.get("free", 0)
    total = fixed + free
    frac = fixed / total if total else 0.0
    if bucket is None or frac >= bucket:
        return None
    return {
        "verdict": "FIXING_STALL",
        "severity": _SEVERITY["FIXING_STALL"],
        "summary": f"bucket {bucket:g} never crossed "
                   f"(fixed {frac:.0%} after {int(it)} iters)",
        "evidence": {"bucket": bucket, "fixed_frac": frac,
                     "it": int(it)},
        "advice": "loosen the fixer tolerance or drop the first "
                  "bucket — the active set is not shrinking",
    }


def diagnose(samples, bound_checks, shrink=None, it=None, cfg=None):
    """Run every rule; returns the fired verdicts ranked most-severe
    first (empty list = HEALTHY). Pure — both the live engine and
    analyze's post-mortem path call exactly this."""
    if it is None and samples:
        it = samples[-1].get("it")
    verdicts = [v for v in (
        rule_stalled_outer(bound_checks, cfg),
        rule_oscillating(samples, cfg),
        rule_culprit_scenarios(samples, cfg),
        rule_fixing_stall(shrink, it, cfg),
    ) if v is not None]
    verdicts.sort(key=lambda v: -v["severity"])
    return verdicts


def overall(verdicts) -> str:
    return verdicts[0]["verdict"] if verdicts else "HEALTHY"


# ---------------- the live engine ----------------

_MAX_SAMPLES = 64          # bounded history: rules read the tail
_MAX_CHECKS = 256


class _State:
    """Per-telemetry-session diagnosis state (the ``obs/profile.py``
    mold: identity-checked against the active Recorder so tests that
    reconfigure sessions never inherit stale history)."""

    __slots__ = ("rec", "lock", "samples", "bound_checks", "shrink",
                 "verdict", "last")

    def __init__(self, rec):
        self.rec = rec
        self.lock = threading.Lock()
        self.samples = []          # forensic sample dicts, tail-capped
        self.bound_checks = []     # hub bound-check dicts, tail-capped
        self.shrink = None         # latest shrink status (plain dict)
        self.verdict = "HEALTHY"
        self.last = {}             # plain dict: the signal-safe view


_STATE: _State | None = None
_STATE_LOCK = threading.Lock()


def _state() -> _State | None:
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


def _refresh(s: _State, it=None):
    """Re-run the rules and rebind the snapshot; emit the transition
    event when the overall verdict changes."""
    with s.lock:
        samples = list(s.samples)
        checks = list(s.bound_checks)
        shrink = dict(s.shrink) if s.shrink else None
    verdicts = diagnose(samples, checks, shrink, it=it)
    name = overall(verdicts)
    fx = samples[-1] if samples else {}
    top_slot = (fx.get("top_slots") or [[None, None]])[0]
    top_scen = (fx.get("scen_pri_shares") or [[None, None]])[0]
    snap = {
        "verdict": name,
        "verdicts": verdicts,
        "top_slot": top_slot[0],
        "top_slot_mass": top_slot[1],
        "top_scen": top_scen[0],
        "top_scen_share": top_scen[1],
        "osc_mean": fx.get("osc_mean"),
        "samples": len(samples),
        "it": it if it is not None else fx.get("it"),
    }
    if name != s.verdict:
        counter_add("forensics.verdict_changes")
        event("forensics.verdict", {
            "verdict": name, "prev": s.verdict, "it": snap["it"],
            "summary": verdicts[0]["summary"] if verdicts else "",
            "evidence": verdicts[0]["evidence"] if verdicts else {}})
    gauge_set("forensics.unhealthy", 0.0 if name == "HEALTHY" else 1.0)
    s.verdict = name
    # rebind, don't mutate: signal handlers and the hub status thread
    # see either the old complete dict or the new one, never a torn mix
    s.last = snap
    return snap


def note_sample(fx: dict, shrink=None):
    """One forensic sample from ``core/ph.py``'s iteration record:
    append to the bounded history, book the ``forensics.*`` gauges,
    emit the compact ``forensics.sample`` event, re-diagnose. Returns
    the refreshed snapshot (None when telemetry is off)."""
    s = _state()
    if s is None:
        return None
    with s.lock:
        s.samples.append(fx)
        del s.samples[:-_MAX_SAMPLES]
        if shrink is not None:
            s.shrink = dict(shrink)
    counter_add("forensics.samples")
    top_slot = (fx.get("top_slots") or [[None, None]])[0]
    top_scen = (fx.get("scen_pri_shares") or [[None, None]])[0]
    if top_slot[0] is not None:
        gauge_set("forensics.top_slot", float(top_slot[0]))
        gauge_set("forensics.top_slot_mass", float(top_slot[1]))
    if top_scen[0] is not None:
        gauge_set("forensics.top_scen", float(top_scen[0]))
        gauge_set("forensics.top_scen_share", float(top_scen[1]))
    if fx.get("osc_mean") is not None:
        gauge_set("forensics.osc_mean", fx["osc_mean"])
    if fx.get("rho_log_ratio_mean") is not None:
        gauge_set("forensics.rho_log_ratio", fx["rho_log_ratio_mean"])
    event("forensics.sample", {
        "it": fx.get("it"), "conv": fx.get("conv"),
        "osc_mean": fx.get("osc_mean"),
        "rho_log_ratio_mean": fx.get("rho_log_ratio_mean"),
        "xbar_move": fx.get("xbar_move"),
        "top_slots": fx.get("top_slots"),
        "scen_pri_shares": fx.get("scen_pri_shares"),
        "scen_dua_shares": fx.get("scen_dua_shares")})
    return _refresh(s, it=fx.get("it"))


def note_bound_check(it, outer, inner, rel_gap, spoke=None):
    """One hub termination check (``cylinders/hub.py``): the bound
    trajectory the STALLED_OUTER rule watches. ``spoke`` = the kind
    that produced the current outer bound, when the hub knows it."""
    s = _state()
    if s is None:
        return None
    with s.lock:
        s.bound_checks.append({"it": it, "outer": outer,
                               "inner": inner, "rel_gap": rel_gap,
                               "spoke": spoke})
        del s.bound_checks[:-_MAX_CHECKS]
    return _refresh(s, it=it)


def snapshot():
    """The current diagnosis as a plain dict (None when telemetry is
    off or nothing has been noted). Safe from signal handlers: one
    attribute read, no locks."""
    s = _STATE
    rec = _active()
    if s is None or rec is None or s.rec is not rec:
        return None
    return s.last or None
