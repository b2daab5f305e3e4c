"""Post-hoc run diagnostics: ``python -m mpisppy_tpu_torch analyze
<dir>`` (a copy of the JAX package's obs/analyze.py: the two packages
write the same artifacts, so each reads the other's runs, and
``--compare`` diffs a JAX run against a port run).

The consumer half of the telemetry layer (the Diagnoser-for-artifacts
the reference ships as a live extension): given a ``--telemetry-dir``
run directory, render a run report — phase breakdown, convergence and
bound trajectory, compile/retrace and gate-sync counts, memory
watermarks, and invariant checks — entirely from the persisted
artifacts, so production runs are debuggable *after the fact* without
re-running anything.

``analyze --compare A B`` diffs two runs' headline metrics with
thresholded verdicts (exit code 3 on REGRESSION), which turns a pair
of bench telemetry dirs into a CI-checkable artifact. Runs whose
``run_header.schema`` versions differ are REFUSED (exit code 2)
instead of mis-parsed — bench.py stamps the same ``schema_version``
into its BENCH JSON rows for the same reason.

Pure host-side JSON work: no jax import, safe to run anywhere.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from dataclasses import dataclass, field


# ---------------- loading ----------------

@dataclass
class Run:
    """One telemetry directory, parsed."""
    path: str
    header: dict                    # hub run_header (or first role's)
    events: list = field(default_factory=list)   # all events, hub first
    roles: dict = field(default_factory=dict)    # role -> its run_header
    metrics: dict = field(default_factory=dict)  # role ('' = hub) -> snap
    trace: dict | None = None
    bad_lines: int = 0
    # earlier sessions found in a REUSED dir (events.jsonl appends
    # across runs while trace/metrics overwrite): their events are
    # dropped so every artifact describes the same — last — run
    earlier_runs: int = 0

    @property
    def schema(self) -> int:
        return int(self.header.get("schema", 1))

    def of(self, etype, role=None):
        return [e for e in self.events if e.get("type") == etype
                and (role is None or e.get("_role") == role)]

    def counters(self, role=""):
        return (self.metrics.get(role) or {}).get("counters", {})

    def gauges(self, role=""):
        return (self.metrics.get(role) or {}).get("gauges", {})

    def histograms(self, role=""):
        return (self.metrics.get(role) or {}).get("histograms", {})


def _role_of(filename, stem, ext):
    base = os.path.basename(filename)
    inner = base[len(stem):-len(ext)]
    return inner[1:] if inner.startswith("-") else ""


def _rotated_chain(base):
    """A role's event files as ONE logical stream, oldest first:
    ``[base.N, ..., base.1, base]`` (size-capped rotation shifts older
    generations to numeric suffixes — obs/events.py)."""
    rotated = []
    for p in glob.glob(base + ".*"):
        suf = p[len(base) + 1:]
        if suf.isdigit():
            rotated.append((int(suf), p))
    return [p for _, p in sorted(rotated, reverse=True)] + [base]


def load_run(path) -> Run:
    """Parse a telemetry directory (hub artifacts + any role-suffixed
    spoke artifacts). Raises FileNotFoundError when no event stream
    exists — the one artifact every session writes. Rotated event
    files (``events.jsonl.1..N``) are re-chained oldest-first into the
    role's stream; their continuation headers (a ``run_header`` with a
    ``rotated`` field) are splice points, not new sessions."""
    ev_files = sorted(glob.glob(os.path.join(path, "events*.jsonl")),
                      key=lambda p: (os.path.basename(p) != "events.jsonl",
                                     p))
    if not ev_files:
        raise FileNotFoundError(
            f"no events*.jsonl under {path!r} — not a telemetry dir? "
            "(runs write one with --telemetry-dir / "
            "MPISPPY_TPU_TELEMETRY_DIR)")
    run = Run(path=path, header={})
    for base in ev_files:
        role = _role_of(base, "events", ".jsonl")
        file_events = []
        for f in _rotated_chain(base):
            try:
                fh = open(f, encoding="utf-8")
            except OSError:
                continue
            with fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        e = json.loads(line)
                    except ValueError:
                        run.bad_lines += 1
                        continue
                    e["_role"] = role
                    if e.get("type") == "run_header":
                        if e.get("rotated"):
                            # continuation header after a size-capped
                            # rotation: same session, keep reading (it
                            # still serves as the role header when the
                            # original rotated off the end of the cap)
                            if role not in run.roles:
                                run.roles[role] = e
                            continue
                        if file_events:
                            # a REUSED dir: events.jsonl appends across
                            # sessions while trace/metrics overwrite —
                            # keep only the LAST session so every
                            # artifact describes the same run (mixing
                            # them garbles trajectories and falsely
                            # fails the monotone-bounds invariant)
                            run.earlier_runs += 1
                            file_events = []
                        run.roles[role] = e
                    file_events.append(e)
        run.events.extend(file_events)
        head = run.roles.get(role)
        if head is not None and (not run.header or role == ""):
            run.header = head
    for f in sorted(glob.glob(os.path.join(path, "metrics*.json"))):
        role = _role_of(f, "metrics", ".json")
        try:
            with open(f, encoding="utf-8") as fh:
                run.metrics[role] = json.load(fh)
        except ValueError:
            run.bad_lines += 1
    if "" not in run.metrics:
        # a killed run may lack metrics.json; the footer carries the
        # same snapshot
        foot = run.of("run_footer", role="")
        if foot and isinstance(foot[-1].get("metrics"), dict):
            run.metrics[""] = foot[-1]["metrics"]
    tr = os.path.join(path, "trace.json")
    if os.path.exists(tr):
        try:
            with open(tr, encoding="utf-8") as fh:
                run.trace = json.load(fh)
        except ValueError:
            run.bad_lines += 1
    return run


# ---------------- derived metrics ----------------

def phase_breakdown(run: Run) -> dict:
    """{mode: {phase: {"seconds": total, "calls": n}}} from the trace's
    phase spans; falls back to the per-iteration records' phase deltas
    (mode-less) when no trace was captured."""
    phases = ("ph.assemble", "ph.solve", "ph.gate", "ph.reduce")
    out = {}
    if run.trace:
        for ev in run.trace.get("traceEvents", ()):
            if ev.get("ph") != "X" or ev.get("name") not in phases:
                continue
            mode = (ev.get("args") or {}).get("mode", "?")
            ent = out.setdefault(mode, {})
            ph = ent.setdefault(ev["name"][3:],
                                {"seconds": 0.0, "calls": 0})
            ph["seconds"] += ev.get("dur", 0.0) / 1e6
            ph["calls"] += 1
    if not out:
        for e in run.of("ph.iteration"):
            ps = e.get("phase_seconds")
            if not isinstance(ps, dict):
                continue
            ent = out.setdefault("(from iteration records)", {})
            for k, v in ps.items():
                ph = ent.setdefault(k, {"seconds": 0.0, "calls": 0})
                ph["seconds"] += v
                ph["calls"] += 1
    return out


def iteration_rows(run: Run) -> list:
    """Per-iteration convergence rows (schema-2 ``ph.iteration``
    records; schema-1 streams carried iter/conv only)."""
    return [e for e in run.of("ph.iteration") if "iter" in e]


def bound_trajectory(run: Run) -> dict:
    t0 = run.header.get("t", 0.0)
    traj = {"outer": [], "inner": []}
    for e in run.of("hub.bound"):
        kind = e.get("kind")
        if kind in traj:
            traj[kind].append((e.get("t", t0) - t0, e.get("char"),
                               e.get("value")))
    return traj


def memory_watermarks(run: Run) -> dict:
    """{role: {device: peak_bytes}} from the mem.* gauges."""
    out = {}
    for role in run.metrics:
        devs = {}
        for name, v in run.gauges(role).items():
            if name.startswith("mem.") \
                    and name.endswith(".peak_bytes_in_use"):
                devs[name.split(".")[1]] = v
        if devs:
            out[role] = devs
    return out


def compile_summary(run: Run) -> dict:
    c = run.counters()
    h = run.histograms().get("jax.compile_seconds", {})
    entries = sorted(((k[len("jax.compile.entry."):], v)
                      for k, v in c.items()
                      if k.startswith("jax.compile.entry.")),
                     key=lambda kv: -kv[1])
    late = [e["iter"] for e in iteration_rows(run)
            if e.get("counter_deltas", {}).get("jax.compiles")
            and e["iter"] > 1]
    return {"compiles": c.get("jax.compiles", 0),
            "traces": c.get("jax.traces", 0),
            "compile_seconds_total": h.get("sum", 0.0) or 0.0,
            "compile_seconds_p99": h.get("p99"),
            "entries": entries,
            "late_retrace_iters": late}


def sharding_summary(run: Run) -> dict | None:
    """The scenario-axis sharding anatomy of a run: device
    count and shard size from the ``ph.iteration`` records' sharding
    block (falling back to ``hub.start``), plus the collective-traffic
    estimate from the ``xfer.collective_bytes`` counter. None when the
    run never sharded."""
    info = None
    iters = 0
    dp_iter = 0
    for e in iteration_rows(run):
        sh = e.get("sharding")
        if isinstance(sh, dict):
            info = sh
            iters += 1
            dp_iter += (e.get("counter_deltas") or {}).get(
                "xfer.device_put_bytes", 0)
    if info is None:
        for e in run.of("hub.start"):
            sh = e.get("sharding")
            if isinstance(sh, dict):
                info = sh
    if info is None:
        return None
    c = run.counters()
    out = dict(info)
    out["collective_bytes_total"] = c.get("xfer.collective_bytes", 0)
    if iters:
        out["collective_bytes_per_iter"] = \
            out["collective_bytes_total"] / iters
    # total includes the legitimate one-time initial shard placement;
    # the ITERATION sum is the steady-state placement contract (must
    # be zero — doc/sharding.md)
    out["device_put_bytes_total"] = c.get("xfer.device_put_bytes", 0)
    out["device_put_bytes_iterations"] = dp_iter
    return out


def fault_summary(run: Run) -> dict:
    """The supervision/ingest-validation story of a run (counters from
    the hub role, per-spoke detail from the events): downs, respawns,
    quarantines, rejected payloads, watchdog — and the derived
    ``degraded`` flag (doc/fault_tolerance.md)."""
    c = run.counters()
    downs = run.of("hub.spoke_down")
    respawns = run.of("hub.spoke_respawn")
    quars = run.of("hub.spoke_quarantined")
    rejects = run.of("hub.bound_rejected")
    watchdog = run.of("hub.watchdog_fired")
    # supervisor events carry the SPOKE kind ("lagrangian"); rejection
    # events carry the BOUND kind ("outer"/"inner"/"cuts") — key rows
    # by spoke index and resolve the spoke kind from the supervisor
    # events, so one spoke's crashes and rejections land on ONE row
    spoke_kind = {e.get("spoke"): e.get("kind", "?")
                  for e in (*downs, *respawns, *quars)
                  if e.get("spoke") is not None}
    per_spoke = {}
    for field_name, evs in (("downs", downs), ("respawns", respawns),
                            ("quarantined", quars),
                            ("rejected", rejects)):
        for e in evs:
            i = e.get("spoke")
            key = "hub" if i is None \
                else f"spoke{i}-{spoke_kind.get(i, '?')}"
            ent = per_spoke.setdefault(key, {"downs": 0, "respawns": 0,
                                             "quarantined": 0,
                                             "rejected": 0,
                                             "reasons": []})
            ent[field_name] += 1
            r = e.get("reason") or e.get("cause")
            if r and r not in ent["reasons"]:
                ent["reasons"].append(r)
    out = {
        # counters are authoritative when metrics survived; a killed
        # run falls back to counting the streamed events
        "downs": int(c.get("hub.spoke_down", 0) or len(downs)),
        "respawns": int(c.get("hub.spoke_respawn", 0) or len(respawns)),
        "quarantined": int(c.get("hub.spoke_quarantined", 0)
                           or len(quars)),
        "rejected_payloads": int(c.get("hub.bound_rejected", 0)
                                 or len(rejects)),
        "crossed_rejections": int(c.get("hub.bound_crossed", 0) or
                                  sum(1 for e in rejects
                                      if e.get("reason") == "crossed")),
        "watchdog_fired": bool(c.get("hub.watchdog_fired", 0)
                               or watchdog),
        "watchdog": (watchdog[-1] if watchdog else None),
        "per_spoke": per_spoke,
    }
    out["degraded"] = bool(out["downs"] or out["quarantined"]
                           or out["rejected_payloads"]
                           or out["watchdog_fired"])
    return out


def incumbent_summary(run: Run) -> dict | None:
    """Device incumbent-pool activity (ops/incumbent, doc/incumbents.md):
    ``incumbent.*`` counters summed across roles (the dive spoke runs
    in its own process in a multi-process wheel, so its counters land
    in a role-suffixed metrics snapshot) plus the per-round
    ``incumbent.round`` event trajectory. None when no pool ever ran —
    the section only renders for wheels with a pool-driven spoke."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith("incumbent."):
                tot[k] = tot.get(k, 0) + v
    rounds_ev = run.of("incumbent.round")
    if not tot and not rounds_ev:
        return None
    rounds = int(tot.get("incumbent.rounds", 0)) or len(rounds_ev)
    evaluated = int(tot.get("incumbent.candidates_evaluated", 0))
    improvements = int(tot.get("incumbent.improvements", 0))
    return {
        "rounds": rounds,
        # pool throughput: candidates per round (the static pool size
        # whenever at least one round completed its evaluation)
        "pool_size": (evaluated // rounds) if rounds else 0,
        "candidates_evaluated": evaluated,
        "feasible": int(tot.get("incumbent.feasible", 0)),
        "improvements": improvements,
        "accept_rate": (improvements / rounds) if rounds else 0.0,
        "pool_reused": int(tot.get("incumbent.pool_reused", 0)),
        "oracle_polish": int(tot.get("incumbent.oracle_polish", 0)),
        "gate_syncs": int(tot.get("incumbent.gate_syncs", 0)),
        "trajectory": [
            {"round": e.get("round"), "best": e.get("best"),
             "bound": e.get("bound"),
             "improved": bool(e.get("improved"))}
            for e in rounds_ev],
    }


def shrink_summary(run: Run) -> dict | None:
    """Progressive-shrinking activity (ops/shrink, doc/extensions.md
    §shrinking): the fixed-fraction trajectory off the per-iteration
    records' ``shrink`` blocks, compaction events, per-bucket s/iter
    means, and the est-HBM drop — the compaction evidence
    that per-iteration cost tracks the ACTIVE set. None when shrinking
    never ran."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith("shrink."):
                tot[k] = tot.get(k, 0) + v
    compactions = run.of("shrink.compaction")
    fixes = run.of("shrink.fix")
    transplants = run.of("shrink.transplant")
    rows = [e for e in iteration_rows(run) if e.get("shrink")]
    if not tot and not compactions and not fixes and not rows:
        return None
    traj = [{"iter": e["iter"],
             "fixed": e["shrink"].get("fixed"),
             "free": e["shrink"].get("free"),
             "bucket": e["shrink"].get("bucket"),
             "seconds": e.get("seconds"),
             "est_hbm_bytes_per_iter":
                 e["shrink"].get("est_hbm_bytes_per_iter")}
            for e in rows]
    # per-bucket s/iter: group the record stream by the bucket active
    # when each iteration ran — the post-compaction drop is the win
    per_bucket = {}
    for t in traj:
        if isinstance(t.get("seconds"), (int, float)):
            b = t.get("bucket") or 0.0
            per_bucket.setdefault(b, []).append(t["seconds"])
    bucket_rows = [
        {"bucket": b, "iters": len(v), "s_per_iter": sum(v) / len(v),
         "est_hbm_bytes_per_iter": next(
             (t["est_hbm_bytes_per_iter"] for t in traj
              if (t.get("bucket") or 0.0) == b
              and t.get("est_hbm_bytes_per_iter") is not None), None)}
        for b, v in sorted(per_bucket.items())]
    # per-bucket post-transition re-convergence: a bucket
    # transition rebuilds the per-scenario ADMM states — warm (the
    # cross-bucket transplant pulled the old bucket's iterates) or
    # cold (a guard booked shrink.transplant_cold_fallbacks). The
    # recovery cost is measured in PH iterations: conv at the
    # transition iteration is the pre level (the compaction lands in
    # that iteration's miditer, so its record still reflects the old
    # system), and recovery is the first later iteration whose conv is
    # back at or under it. Warm should recover in strictly fewer
    # iterations — the --compare cold-fallback verdict reads the
    # counter, this table shows the price actually paid.
    all_rows = [e for e in iteration_rows(run)
                if isinstance(e.get("conv"), (int, float))]
    warm_buckets = {e.get("bucket") for e in transplants}
    reconvergence = []
    for ev in compactions:
        t = ev.get("iter")
        if t is None:
            continue
        pre = next((e["conv"] for e in reversed(all_rows)
                    if e["iter"] <= t), None)
        recovered = None
        if pre is not None:
            recovered = next((e["iter"] for e in all_rows
                              if e["iter"] > t and e["conv"] <= pre),
                             None)
        reconvergence.append({
            "bucket": ev.get("bucket"), "iter": t,
            "mode": ("warm" if ev.get("bucket") in warm_buckets
                     else "cold"),
            "pre_conv": pre,
            "recovered_iter": recovered,
            "iters_to_reconverge":
                (recovered - t) if recovered is not None else None})
    return {
        "fixed_final": (traj[-1]["fixed"] if traj else None),
        "free_final": (traj[-1]["free"] if traj else None),
        "fixed_new_total": int(tot.get("shrink.fixed_new", 0)),
        "compactions": int(tot.get("shrink.compactions", 0))
        or len(compactions),
        "compaction_skipped": int(tot.get("shrink.compaction_skipped",
                                          0)),
        "rho_updates": int(tot.get("shrink.rho_updates", 0)),
        "bucket_compiles": int(tot.get("shrink.bucket.compile", 0)),
        "bucket_cache_hits": int(tot.get("shrink.bucket.cache_hit", 0)),
        "transplants": int(tot.get("shrink.transplants", 0)),
        "transplant_cold_fallbacks":
            int(tot.get("shrink.transplant_cold_fallbacks", 0)),
        "reconvergence": reconvergence,
        "compaction_events": [
            {"iter": e.get("iter"), "bucket": e.get("bucket"),
             "n_cols": e.get("n_cols"), "m_rows": e.get("m_rows"),
             "n_full": e.get("n_full"), "m_full": e.get("m_full"),
             "fingerprint": e.get("fingerprint"),
             "bucket_cached": e.get("bucket_cached")}
            for e in compactions],
        "per_bucket": bucket_rows,
        "trajectory": traj,
    }


def truncated(run: Run) -> bool:
    """True when the hub never wrote its ``run_footer`` — the run was
    killed before shutdown. Every report/compare section stamps this
    uniformly (``TRUNCATED RUN``) so partial artifacts read as partial
    instead of section-dependent silence."""
    return not run.of("run_footer", role="")


def roofline_summary(run: Run) -> dict | None:
    """The measured roofline (obs/profile.py, doc/roofline.md): device
    peaks from the ``profile.device`` event, per-iteration /
    per-bucket / per-mode MFU and HBM-bandwidth utilization from the
    ``profile.flops`` / ``profile.hbm_bytes`` counter deltas joined
    against the span timeline, the per-entry static cost models, and
    the compile ledger (which must sum to ``jax.compiles``). None when
    the run never profiled (telemetry off or pre-profile artifacts)."""
    c = run.counters()
    dev_events = run.of("profile.device")
    entry_events = run.of("profile.entry")
    if not dev_events and not entry_events \
            and not any(k.startswith("profile.") for k in c):
        return None
    dev = {}
    if dev_events:
        dev = {k: v for k, v in dev_events[-1].items()
               if k not in ("t", "type", "_role")}
    peak_f = dev.get("peak_flops") or 0.0
    peak_g = dev.get("peak_hbm_gbps") or 0.0
    per_iter = []
    per_bucket = {}
    per_mode = {}
    solve_flops = solve_secs = 0.0
    tot_flops = tot_bytes = tot_secs = 0.0
    for e in iteration_rows(run):
        cd = e.get("counter_deltas") or {}
        fl = float(cd.get("profile.flops", 0) or 0)
        by = float(cd.get("profile.hbm_bytes", 0) or 0)
        if not fl and not by:
            continue
        secs = e.get("seconds")
        if not isinstance(secs, (int, float)) or secs <= 0:
            continue
        row = {"iter": e.get("iter"), "seconds": secs, "flops": fl,
               "hbm_bytes": by,
               "mfu": (fl / secs / peak_f) if peak_f else None,
               "hbm_gbps": by / secs / 1e9,
               "hbm_util": (by / secs / 1e9 / peak_g) if peak_g
               else None}
        per_iter.append(row)
        tot_flops += fl
        tot_bytes += by
        tot_secs += secs
        ps = e.get("phase_seconds") or {}
        sv = ps.get("solve")
        if isinstance(sv, (int, float)) and sv > 0:
            solve_flops += fl
            solve_secs += sv
        # bucket = the shrink bucket active when the iteration ran
        # (the shrink_summary grouping); 0.0 = the full-width system
        shr = e.get("shrink") or {}
        b = shr.get("bucket") or 0.0
        ent = per_bucket.setdefault(
            b, {"flops": 0.0, "hbm_bytes": 0.0, "seconds": 0.0,
                "iters": 0, "est_hbm_bytes_per_iter": None})
        ent["flops"] += fl
        ent["hbm_bytes"] += by
        ent["seconds"] += secs
        ent["iters"] += 1
        if ent["est_hbm_bytes_per_iter"] is None:
            ent["est_hbm_bytes_per_iter"] = \
                shr.get("est_hbm_bytes_per_iter")
        # engine mode, classified the way kernel_summary does: a
        # kernel.fused_iters delta marks a fused iteration
        mode = "fused" if cd.get("kernel.fused_iters") else "segmented"
        m = per_mode.setdefault(
            mode, {"flops": 0.0, "hbm_bytes": 0.0, "seconds": 0.0,
                   "iters": 0})
        m["flops"] += fl
        m["hbm_bytes"] += by
        m["seconds"] += secs
        m["iters"] += 1

    def _figures(fl, by, secs):
        if secs <= 0:
            return {"mfu": None, "hbm_gbps": None, "hbm_util": None}
        gbps = by / secs / 1e9
        return {"mfu": (fl / secs / peak_f) if peak_f else None,
                "hbm_gbps": gbps,
                "hbm_util": (gbps / peak_g) if peak_g else None}

    bucket_rows = []
    for b, ent in sorted(per_bucket.items()):
        row = {"bucket": b, "iters": ent["iters"],
               "s_per_iter": ent["seconds"] / ent["iters"],
               "flops_per_iter": ent["flops"] / ent["iters"],
               "hbm_bytes_per_iter": ent["hbm_bytes"] / ent["iters"],
               "est_hbm_bytes_per_iter": ent["est_hbm_bytes_per_iter"]}
        row.update(_figures(ent["flops"], ent["hbm_bytes"],
                            ent["seconds"]))
        bucket_rows.append(row)
    mode_rows = {}
    for m, ent in sorted(per_mode.items()):
        row = {"iters": ent["iters"],
               "flops_per_iter": ent["flops"] / ent["iters"],
               "hbm_bytes_per_iter": ent["hbm_bytes"] / ent["iters"]}
        row.update(_figures(ent["flops"], ent["hbm_bytes"],
                            ent["seconds"]))
        mode_rows[m] = row
    ledger = {}
    for k, v in c.items():
        if k.startswith("profile.ledger.compiles."):
            key = k[len("profile.ledger.compiles."):]
            ledger.setdefault(key, {"compiles": 0, "seconds": 0.0})
            ledger[key]["compiles"] = int(v)
        elif k.startswith("profile.ledger.seconds."):
            key = k[len("profile.ledger.seconds."):]
            ledger.setdefault(key, {"compiles": 0, "seconds": 0.0})
            ledger[key]["seconds"] = float(v)
    ledger_compiles = sum(e["compiles"] for e in ledger.values())
    jax_compiles = int(c.get("jax.compiles", 0))
    overall = {"flops_total": tot_flops, "hbm_bytes_total": tot_bytes,
               "seconds_total": tot_secs, "iters": len(per_iter)}
    overall.update(_figures(tot_flops, tot_bytes, tot_secs))
    solve = {"flops_total": solve_flops, "seconds_total": solve_secs}
    solve.update(_figures(solve_flops, 0.0, solve_secs))
    solve.pop("hbm_gbps", None)
    solve.pop("hbm_util", None)
    unavailable = [{k: v for k, v in e.items()
                    if k in ("entry", "reason")}
                   for e in run.of("profile.unavailable")]
    return {
        "device": dev or None,
        "overall": overall,
        "solve_phase": solve if solve_secs > 0 else None,
        "per_bucket": bucket_rows,
        "per_mode": mode_rows,
        "per_iteration": per_iter,
        "entries": [{k: v for k, v in e.items()
                     if k not in ("t", "type", "_role")}
                    for e in entry_events],
        "captures": int(c.get("profile.captures", 0)),
        "ledger": ledger,
        "ledger_compiles": ledger_compiles,
        "jax_compiles": jax_compiles,
        "ledger_matches": ledger_compiles == jax_compiles,
        "unavailable_count": int(c.get("profile.unavailable", 0)),
        "unavailable": unavailable,
    }


def streaming_summary(run: Run) -> dict | None:
    """Scenario-streaming activity (mpisppy_tpu/stream,
    doc/streaming.md): the source kind, bytes shipped vs chunks
    synthesized, prefetch occupancy (how often the consumer outran the
    double buffer), int8 gate fallbacks, and THE acceptance signal —
    whether the per-iteration ``xfer.device_put_bytes`` deltas stayed
    flat across steady-state iterations. None when no scenario source
    ran."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith("stream."):
                tot[k] = tot.get(k, 0) + v
    rows = [e for e in iteration_rows(run) if e.get("stream")]
    if not tot and not rows:
        return None
    source = rows[-1]["stream"].get("source") if rows else None
    chunks = int(tot.get("stream.chunks_shipped", 0))
    synth = int(tot.get("stream.synth_chunks", 0))
    stalls = int(tot.get("stream.prefetch_stalls", 0))
    staged = chunks + synth
    # per-iteration device_put deltas from the counter_deltas blocks:
    # steady state starts at the SECOND recorded iteration (iteration 1
    # builds the mode's cold chunk states — one direct fetch)
    per_iter = [
        {"iter": e["iter"],
         "device_put_bytes":
             e.get("counter_deltas", {}).get("xfer.device_put_bytes", 0),
         "bytes_shipped":
             e.get("counter_deltas", {}).get("stream.bytes_shipped", 0),
         "synth_chunks":
             e.get("counter_deltas", {}).get("stream.synth_chunks", 0),
         "compacted_transitions":
             e.get("counter_deltas", {}).get(
                 "stream.compacted_transitions", 0)}
        for e in iteration_rows(run)]
    # steady state starts after the LAST compacted re-block (
    # shrink×stream): a transition legitimately changes the shipped
    # width (and pays its one out-of-band restage), so flatness is
    # judged on the iterations solving the final layout — otherwise
    # every compacted streamed wheel would read as a leak
    start = 1
    for i, r_ in enumerate(per_iter):
        if r_["compacted_transitions"]:
            start = max(start, i + 1)
    steady = [r["device_put_bytes"] for r in per_iter[start:]]
    return {
        "source": source,
        "chunks_shipped": chunks,
        "bytes_shipped": int(tot.get("stream.bytes_shipped", 0)),
        "synth_chunks": synth,
        "direct_fetches": int(tot.get("stream.direct_fetches", 0)),
        "int8_fallbacks": int(tot.get("stream.int8_fallbacks", 0)),
        "compacted_transitions":
            int(tot.get("stream.compacted_transitions", 0)),
        "compacted_restage_bytes":
            int(tot.get("stream.compacted_restage_bytes", 0)),
        "prefetch_stalls": stalls,
        # fraction of staged chunks the prefetcher had ready before the
        # consumer asked — 1.0 means the H2D fully hid under compute
        "prefetch_occupancy":
            (1.0 - stalls / staged) if staged else None,
        "device_put_flat_steady_state":
            (len(set(steady)) <= 1) if len(steady) >= 2 else None,
        "per_iteration": per_iter,
    }


def aph_summary(run: Run) -> dict | None:
    """APH φ-dispatch activity (core/aph.py + ops/dispatch.py,
    doc/aph.md): the dispatched-fraction trajectory, φ histogram
    stats, skipped-solve savings, dispatch-bucket compile behavior,
    and THE pacing signal — gate syncs per iteration (the stacked-gate
    contract says exactly one D2H per APH iteration). None when no
    APH wheel ran — the section only renders for APH telemetry."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith(("aph.", "dispatch.")):
                tot[k] = tot.get(k, 0) + v
    rows = [e for e in iteration_rows(run) if e.get("aph")]
    if not tot and not rows:
        return None
    traj = [{"iter": e["iter"],
             "frac": e["aph"].get("frac"),
             "dispatched": e["aph"].get("dispatched"),
             "S_real": e["aph"].get("S_real"),
             "solve_path": e["aph"].get("solve_path"),
             "phi_min": e["aph"].get("phi_min"),
             "phi_max": e["aph"].get("phi_max"),
             "phi_neg": e["aph"].get("phi_neg")}
            for e in rows]
    iters = len(rows)
    syncs = int(tot.get("aph.gate_syncs", 0))
    solved = int(tot.get("dispatch.solved_scenarios", 0))
    skipped = int(tot.get("dispatch.skipped_scenarios", 0))
    last = rows[-1]["aph"] if rows else {}
    return {
        "iterations": iters,
        "dispatch_frac": last.get("frac"),
        "solve_path": last.get("solve_path"),
        "gate_syncs": syncs,
        # the O(1)-host-traffic acceptance signal: must sit at ~1.0
        "gate_syncs_per_iteration": (syncs / iters) if iters else None,
        "solved_scenarios": solved,
        "skipped_scenarios": skipped,
        # fraction of scenario-solves partial dispatch saved outright
        "skipped_solve_savings":
            (skipped / (solved + skipped)) if (solved + skipped) else None,
        "solved_per_iteration": (solved / iters) if iters else None,
        "bucket_compiles": int(tot.get("dispatch.bucket.compile", 0)),
        "bucket_cache_hits": int(tot.get("dispatch.bucket.cache_hit", 0)),
        "phi_neg_final": last.get("phi_neg"),
        "trajectory": traj,
    }


def forensics_summary(run: Run) -> dict | None:
    """Wheel forensics (ops/forensics.py + obs/diagnose.py,
    doc/forensics.md): the per-slot/per-scenario attribution samples
    off the iteration records (or the dedicated ``forensics.sample``
    stream on merged multi-role runs), the hub bound trajectory, and a
    POST-MORTEM re-run of the same pure diagnosis rules the live
    engine uses — a recorded stall is re-attributed even when the run
    died before the live engine fired. None when the run carries no
    forensic data at all."""
    from . import diagnose as _diagnose
    samples = []
    for e in iteration_rows(run):
        fx = e.get("forensics")
        if isinstance(fx, dict):
            samples.append(fx)
    if not samples:
        samples = [e for e in run.of("forensics.sample")
                   if e.get("it") is not None]
    verdict_events = [
        {"it": e.get("it"), "verdict": e.get("verdict"),
         "prev": e.get("prev"), "summary": e.get("summary"),
         "evidence": e.get("evidence")}
        for e in run.of("forensics.verdict")]
    bound_checks = [
        {"it": e.get("iter"), "outer": e.get("outer"),
         "inner": e.get("inner"), "rel_gap": e.get("rel_gap"),
         "spoke": None}
        for e in run.of("hub.iteration")]
    if not samples and not verdict_events:
        return None
    # stalled-outer spoke attribution, post-mortem: the char that
    # produced the last outer-bound publish (screen rows stop when
    # bounds freeze, so the LAST one names the spoke that froze);
    # merged runs fall back to the live engine's recorded attribution
    spoke = None
    for e in reversed(run.of("hub.screen_row")):
        ch = e.get("ob_char")
        if isinstance(ch, str) and ch.strip():
            spoke = _diagnose.SPOKE_CHARS.get(ch, ch)
            break
    if spoke is None:
        for v in reversed(verdict_events):
            sp = (v.get("evidence") or {}).get("spoke")
            if sp:
                spoke = sp
                break
    for b in bound_checks:
        b["spoke"] = spoke
    verdicts = _diagnose.diagnose(samples, bound_checks)
    last = samples[-1] if samples else {}
    return {
        "verdict": _diagnose.overall(verdicts),
        "verdicts": verdicts,
        "samples": len(samples),
        "bound_checks": len(bound_checks),
        "verdict_events": verdict_events,
        "last": {
            "it": last.get("it"), "conv": last.get("conv"),
            "osc_mean": last.get("osc_mean"),
            "rho_log_ratio_mean": last.get("rho_log_ratio_mean"),
            "xbar_move": last.get("xbar_move"),
            "top_slots": last.get("top_slots"),
            "scen_pri_shares": last.get("scen_pri_shares"),
            "scen_dua_shares": last.get("scen_dua_shares"),
        } if samples else None,
    }


def checkpoint_summary(run: Run) -> dict | None:
    """Durable checkpoint activity (the JAX package's ckpt,
    doc/fault_tolerance.md): ``ckpt.*`` counters summed across roles
    (spoke warm-state writes land in spoke roles), the capture
    trajectory, resume provenance, and rejected-bundle reasons. None
    when checkpointing never ran — the section only renders for
    checkpointing wheels."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith("ckpt."):
                tot[k] = tot.get(k, 0) + v
    captures = run.of("ckpt.capture")
    resumes = run.of("ckpt.resume")
    rejected = run.of("ckpt.resume_rejected")
    preempts = run.of("hub.preempted")
    if not tot and not captures and not resumes and not rejected:
        return None
    rej_reasons = {}
    for k, v in tot.items():
        if k.startswith("ckpt.rejected."):
            rej_reasons[k[len("ckpt.rejected."):]] = \
                rej_reasons.get(k[len("ckpt.rejected."):], 0) + int(v)
    for e in rejected:
        rej_reasons.setdefault(e.get("reason"), 0)
    last = captures[-1] if captures else {}
    return {
        "captures": int(tot.get("ckpt.captures", 0)) or len(captures),
        "write_failed": int(tot.get("ckpt.write_failed", 0)),
        "spoke_writes": int(tot.get("ckpt.spoke_writes", 0)),
        "last_bundle": last.get("bundle"),
        "last_iter": last.get("iter"),
        "reasons": sorted({e.get("reason") for e in captures
                           if e.get("reason")}),
        "resumed": bool(resumes)
        or bool(int(tot.get("ckpt.resumed", 0))),
        "resume": (resumes[-1] if resumes else None),
        "spoke_resumed": int(tot.get("ckpt.spoke_resumed", 0)),
        "rejected": rej_reasons,
        "preempted": bool(preempts)
        or bool(run.counters().get("hub.preempted")),
    }


def serving_summary(run: Run) -> dict | None:
    """Serving-layer activity (serve/, either package's service):
    request admission/outcome totals, warm-cache hit ratio, the batch
    occupancy histogram, and per-bucket compile counts (in the port's
    service, its kernel and factor builds). None when the
    run never served — the section only renders for serve-process
    telemetry dirs."""
    tot = {}
    for role in run.metrics:
        for k, v in run.counters(role).items():
            if k.startswith("serve."):
                tot[k] = tot.get(k, 0) + v
    if not tot and not run.of("serve.start"):
        return None
    hits = int(tot.get("serve.cache.hit", 0))
    misses = int(tot.get("serve.cache.miss", 0))
    per_bucket = {k[len("serve.bucket.compiles."):]: int(v)
                  for k, v in tot.items()
                  if k.startswith("serve.bucket.compiles.")}
    occ = None
    for role in run.metrics:
        h = run.histograms(role).get("serve.batch.occupancy")
        if h:
            occ = h
            break
    # migration ledger (doc/serving.md): every offer settles in the
    # SAME process as exactly one of handed_off / aborted.<reason>, so
    # summed-across-roles totals must reconcile — a gap means an offer
    # path returned without booking its outcome
    mig_offered = int(tot.get("serve.migrate.offered", 0))
    mig_aborted = {k[len("serve.migrate.aborted."):]: int(v)
                   for k, v in tot.items()
                   if k.startswith("serve.migrate.aborted.")}
    mig_rejected = {k[len("serve.migrate.rejected."):]: int(v)
                    for k, v in tot.items()
                    if k.startswith("serve.migrate.rejected.")}
    migration = None
    if mig_offered or mig_aborted or tot.get("serve.migrate.committed"):
        handed = int(tot.get("serve.migrate.handed_off", 0))
        migration = {
            "offered": mig_offered,
            "handed_off": handed,
            "accepted": int(tot.get("serve.migrate.accepted", 0)),
            "committed": int(tot.get("serve.migrate.committed", 0)),
            "completed": int(tot.get("serve.migrate.completed", 0)),
            "aborted": mig_aborted,
            "rejected": mig_rejected,
            "reconciled": mig_offered == handed
            + sum(mig_aborted.values()),
        }
    return {
        "admitted": int(tot.get("serve.requests.admitted", 0)),
        "completed": int(tot.get("serve.requests.completed", 0)),
        "failed": int(tot.get("serve.requests.failed", 0)),
        "rejected": int(tot.get("serve.requests.rejected", 0)),
        "deadline_missed": int(tot.get("serve.requests.deadline_missed",
                                       0)),
        "preempted_requests": int(tot.get("serve.requests.preempted",
                                          0)),
        "resumed": int(tot.get("serve.requests.resumed", 0)),
        "wheels": int(tot.get("serve.wheels", 0)),
        "stacked_wheels": int(tot.get("serve.batch.wheels", 0)),
        "coalesced": int(tot.get("serve.batch.coalesced", 0)),
        "chain_steps": int(tot.get("serve.chain.steps", 0)),
        "cache_hits": hits, "cache_misses": misses,
        "cache_evictions": int(tot.get("serve.cache.evict", 0)),
        "cache_hit_ratio": (hits / (hits + misses))
        if hits + misses else None,
        "batch_occupancy": occ,
        "per_bucket_compiles": per_bucket,
        "service_preempted": bool(int(tot.get("serve.preempted", 0))),
        "drained": bool(int(tot.get("serve.drained", 0))),
        "quarantined": int(tot.get("serve.request.quarantined", 0)),
        "migration": migration,
    }


def bound_flow_summary(run: Run) -> dict | None:
    """Per-spoke bound-flow ledger + verdict — the live-plane answer to
    ROADMAP item 1's diagnostic question ("is the Lagrangian spoke
    starved, too slow, or having its bounds rejected?"). Assembled from
    three independent sources so a killed run still renders:

    - hub metrics: ``hub.spoke.produced_writes/.consumed_writes/.lag``
      gauges, ``hub.spoke.staleness_seconds`` histograms,
      ``hub.spoke.bounds_accepted/.bounds_rejected`` counters,
    - spoke ROLE metrics: ``spoke.bound_updates`` (the spoke-side
      publish truth, summed across respawned generations) and the
      ``spoke.bound_interval_seconds`` cadence histogram,
    - the ``hub.iteration`` events' ``flow`` time series (produced vs
      consumed at every termination check — the silent-starvation
      signal).

    Verdicts (doc/observability.md documents the thresholds):
    REJECTED — the hub quarantined at least as many of this spoke's
    payloads as it accepted; STARVED — publishes advance while hub
    consumption stays flat (streak in the flow series), or the hub
    missed at least half of ≥4 publishes (window overwrites), or
    publishes were never consumed at all; SLOW — the spoke published
    ≤1 bound across ≥10 hub checks, or its publish cadence p50 is
    >5x the hub's iteration p50; HEALTHY otherwise. None when the run
    carries no flow data at all (pre-live-plane artifacts)."""
    spokes: dict[str, dict] = {}
    # verdicts need HUB-SIDE lineage evidence (flow gauges/counters/
    # histograms or the hub.iteration flow series). Spoke-role
    # counters alone (older streams carry spoke.bound_updates) must NOT
    # suffice: a pre-live-plane dir would otherwise read "published
    # but never consumed" — a false STARVED on every healthy old run.
    got_hub_flow = False
    g, c, hists = run.gauges(), run.counters(), run.histograms()
    for name, v in g.items():
        for prefix, key in (("hub.spoke.produced_writes.", "produced"),
                            ("hub.spoke.consumed_writes.", "consumed"),
                            ("hub.spoke.lag.", "lag")):
            if name.startswith(prefix):
                spokes.setdefault(name[len(prefix):], {})[key] = int(v)
                got_hub_flow = True
    for name, v in c.items():
        for prefix, key in (("hub.spoke.bounds_accepted.", "accepted"),
                            ("hub.spoke.bounds_rejected.", "rejected")):
            if name.startswith(prefix):
                spokes.setdefault(name[len(prefix):], {})[key] = int(v)
                got_hub_flow = True
    for name, h in hists.items():
        pre = "hub.spoke.staleness_seconds."
        if name.startswith(pre) and isinstance(h, dict):
            ent = spokes.setdefault(name[len(pre):], {})
            ent["staleness_p50"] = h.get("p50")
            ent["staleness_p99"] = h.get("p99")
            got_hub_flow = True
    # spoke-side truth from the role artifacts (summed across
    # respawned generations: role "spoke0-lagrangian-r1" -> "spoke0")
    for role in run.metrics:
        if not role.startswith("spoke"):
            continue
        label, _, kind = role.partition("-")
        ent = spokes.setdefault(label, {})
        if kind:
            ent.setdefault("kind", kind.split("-")[0])
        rc = run.counters(role)
        ent["published"] = ent.get("published", 0) \
            + int(rc.get("spoke.bound_updates", 0))
        hh = run.histograms(role).get("spoke.bound_interval_seconds")
        if isinstance(hh, dict) and hh.get("p50") is not None:
            ent["publish_interval_p50"] = hh["p50"]
    # flow time series: longest streak of checks where produced
    # advanced while consumed stayed flat (the silent-starvation case
    # neither the faults section nor no_late_retraces can see)
    it_events = run.of("hub.iteration", role="")
    series = [e["flow"] for e in it_events
              if isinstance(e.get("flow"), dict)]
    if series:
        got_hub_flow = True
    streaks: dict[str, int] = {}
    cur: dict[str, int] = {}
    prev = None
    for flow in series:
        if prev is not None:
            for label, ent in flow.items():
                p0 = (prev.get(label) or {}).get("produced", 0)
                c0 = (prev.get(label) or {}).get("consumed", 0)
                if ent.get("produced", 0) > p0 \
                        and ent.get("consumed", 0) == c0:
                    cur[label] = cur.get(label, 0) + 1
                    streaks[label] = max(streaks.get(label, 0),
                                         cur[label])
                else:
                    cur[label] = 0
        prev = flow
    if series:
        for label, ent in spokes.items():
            last = series[-1].get(label) or {}
            ent.setdefault("produced", int(last.get("produced", 0)))
            ent.setdefault("consumed", int(last.get("consumed", 0)))
            ent["starvation_streak"] = streaks.get(label, 0)
    if not spokes or not got_hub_flow:
        return None
    it_hist = hists.get("ph.iteration_seconds") or {}
    n_checks = len(it_events)
    for ent in spokes.values():
        ent["verdict"], ent["why"] = _flow_verdict(ent, it_hist,
                                                   n_checks)
    return dict(sorted(spokes.items()))


def _flow_verdict(ent, it_hist, n_checks):
    produced = max(int(ent.get("produced", 0)),
                   int(ent.get("published", 0)))
    consumed = int(ent.get("consumed", 0))
    accepted = int(ent.get("accepted", 0))
    rejected = int(ent.get("rejected", 0))
    lag = produced - consumed
    if rejected and rejected >= max(1, accepted):
        return "REJECTED", (f"{rejected} payload(s) rejected vs "
                            f"{accepted} accepted — see the faults "
                            "section for reasons")
    if produced and not consumed:
        return "STARVED", (f"{produced} publish(es) but the hub never "
                           "consumed one")
    if ent.get("starvation_streak", 0) >= 3:
        return "STARVED", (f"publishes advanced across "
                           f"{ent['starvation_streak']} consecutive hub "
                           "checks while consumption stayed flat")
    if produced >= 4 and lag >= (produced + 1) // 2:
        return "STARVED", (f"hub consumed only {consumed} of {produced} "
                           "publishes (window overwrote the rest)")
    if produced <= 1 and n_checks >= 10:
        return "SLOW", (f"{produced} bound(s) published across "
                        f"{n_checks} hub checks")
    it_p50 = it_hist.get("p50")
    pub_p50 = ent.get("publish_interval_p50")
    # hub p50 floored at 0.2 s: ms-scale toy hubs out-iterate any
    # spoke, and sub-second cadence is never the binding diagnosis
    if it_p50 and pub_p50 and pub_p50 > 5.0 * max(it_p50, 0.2):
        return "SLOW", (f"publish cadence p50 {pub_p50:.2g}s vs hub "
                        f"iteration p50 {it_p50:.2g}s")
    return "HEALTHY", ""


_UNSET = object()


def invariant_checks(run: Run, bound_flow=_UNSET) -> list:
    """[(name, ok, detail, severity)] — the afterward-checkable
    contracts. severity "fail" renders [FAIL] when violated; "warn"
    renders [WARN] for checks whose violation has benign explanations
    (counter deltas are process-global, so an in-process spoke
    thread's legitimate first compile can land inside a hub
    iteration's window). ``bound_flow`` lets callers that already
    computed :func:`bound_flow_summary` (render_report, the --json
    path) pass it in instead of paying its event scans twice."""
    checks = []
    c = run.counters()
    calls = c.get("ph.solve_loop_calls", 0)
    syncs = c.get("ph.gate_syncs", 0)
    if calls:
        per = syncs / calls
        # pipelined chunked mode pays 1/call (+ exceptional retries /
        # hospital); sequential opt-out pays one per chunk. <= 2 is
        # the O(1) contract with recovery headroom.
        checks.append(("gate_syncs_per_solve_call_O1", per <= 2.0,
                       f"{per:.2f} (ph.gate_syncs {syncs} / "
                       f"ph.solve_loop_calls {calls})", "fail"))
    traj = bound_trajectory(run)
    ok_outer = all(prev[2] <= cur[2] for prev, cur in
                   zip(traj["outer"], traj["outer"][1:]))
    ok_inner = all(cur[2] <= prev[2] for prev, cur in
                   zip(traj["inner"], traj["inner"][1:]))
    if traj["outer"] or traj["inner"]:
        checks.append(("bound_updates_monotone", ok_outer and ok_inner,
                       f"{len(traj['outer'])} outer / "
                       f"{len(traj['inner'])} inner updates", "fail"))
    checks.append(("events_parse_clean", run.bad_lines == 0,
                   f"{run.bad_lines} unparseable line(s)", "fail"))
    checks.append(("single_run_in_dir", run.earlier_runs == 0,
                   ("one session" if not run.earlier_runs else
                    f"{run.earlier_runs} earlier session(s) appended in "
                    "this dir were ignored (events.jsonl appends across "
                    "runs; trace/metrics hold only the last) — use a "
                    "fresh --telemetry-dir per run for full history"),
                   "warn"))
    foot = run.of("run_footer", role="")
    checks.append(("clean_shutdown_footer", bool(foot),
                   "run_footer present" if foot else
                   "no run_footer (killed run?)", "fail"))
    schemas = {int(h.get("schema", 1)) for h in run.roles.values()}
    checks.append(("schema_consistent_across_roles", len(schemas) <= 1,
                   f"versions {sorted(schemas)}", "fail"))
    comp = compile_summary(run)
    # WARN, not FAIL: compile counters are process-global, so an
    # in-process spoke thread's legitimate first-time compile can land
    # inside a hub iteration's delta window (threaded spin_the_wheel)
    checks.append(("no_late_retraces", not comp["late_retrace_iters"],
                   ("none" if not comp["late_retrace_iters"] else
                    f"XLA compiles during iterations "
                    f"{comp['late_retrace_iters']} — a hot-loop shape/"
                    "static-arg drift is retracing (or an in-process "
                    "spoke thread's warmup)"), "warn"))
    # WARN, not FAIL: the wheel is DESIGNED to survive these (that is
    # the supervisor's whole job), but a quarantined spoke or a
    # corrupt/crossed payload means the run lost a bound source or
    # fought corruption — a clean run stays all-PASS
    f = fault_summary(run)
    degraded = f["quarantined"] > 0 or f["crossed_rejections"] > 0
    checks.append(("no_quarantines_or_corruption", not degraded,
                   ("clean" if not degraded else
                    f"{f['quarantined']} spoke(s) quarantined, "
                    f"{f['crossed_rejections']} crossed-bound "
                    "rejection(s) — see the faults section"), "warn"))
    # WARN, not FAIL: the silent-starvation case the faults section
    # and no_late_retraces both miss — a spoke whose produced write
    # ids advance while the hub's consumed ids stay flat is wasting
    # its whole compute budget on bounds nobody reads, yet crashes
    # nothing and retraces nothing
    bf = bound_flow_summary(run) if bound_flow is _UNSET else bound_flow
    if bf is not None:
        starved = {label: ent for label, ent in bf.items()
                   if ent.get("verdict") == "STARVED"}
        checks.append((
            "no_silent_starvation", not starved,
            ("all spokes consumed" if not starved else
             "; ".join(f"{label}: {ent['why']}"
                       for label, ent in starved.items())
             + " — see the bound flow section"), "warn"))
    return checks


# ---------------- report rendering ----------------

def _fmt_b(n):
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} PB"


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def lint_summary(run: Run) -> dict | None:
    """The lint stamp: when the telemetry dir carries
    a ``lint.json`` report (``python -m tools.lint --out <dir>/lint.json``
    — tools/regression_gate.py writes one beside the fresh bench), the
    report gets a one-line lint-status stamp. None when absent."""
    p = os.path.join(run.path, "lint.json")
    if not os.path.exists(p):
        return None
    try:
        with open(p, encoding="utf-8") as f:
            rep = json.load(f)
    except (OSError, ValueError):
        rep = None
    if not isinstance(rep, dict):
        # unreadable / torn / non-object payload: stamp it as such
        # rather than aborting the whole run report
        return {"status": "unreadable", "findings": None,
                "suppressed": None, "files_checked": None}
    findings = rep.get("findings") or []
    return {"status": "clean" if not findings else "findings",
            "findings": len(findings),
            "suppressed": len(rep.get("suppressed") or []),
            "files_checked": rep.get("files_checked")}


def _lint_line(ls: dict) -> str:
    if ls["status"] == "unreadable":
        return "lint: lint.json present but unreadable"
    head = ("clean" if ls["status"] == "clean"
            else f"{ls['findings']} FINDING(S)")
    return (f"lint: {head}  ({ls['files_checked']} files, "
            f"{ls['suppressed']} suppressed) [lint.json]")


def _stamp_truncated(text: str) -> str:
    """Append the ``TRUNCATED RUN`` stamp to every section header —
    uniform truncated-run handling (a run killed before its
    ``run_footer``): each section explicitly says it reflects the last
    flushed events, instead of section-dependent silence."""
    return "\n".join(
        ln + "  [TRUNCATED RUN]" if ln.startswith("== ") else ln
        for ln in text.splitlines())


def render_report(run: Run) -> str:
    L = []
    h = run.header
    cfg = h.get("config") or {}
    trunc = truncated(run)
    L.append(f"== run == {run.path}")
    if trunc:
        L.append("TRUNCATED RUN: no run_footer — the run was killed "
                 "before shutdown; every section below reflects the "
                 "last flushed events, not a completed run")
    L.append(f"run_id {h.get('run_id')}  schema {run.schema}  "
             f"started {h.get('wall_time_iso')}  "
             f"roles [{', '.join(r or 'hub' for r in sorted(run.roles))}]")
    ls = lint_summary(run)
    if ls is not None:
        L.append(_lint_line(ls))
    if isinstance(cfg, dict) and cfg.get("model"):
        L.append(f"model {cfg.get('model')}  "
                 f"num_scens {cfg.get('num_scens')}  "
                 f"hub {cfg.get('hub')}  "
                 f"spokes {[s.get('kind') for s in cfg.get('spokes', [])]}")
    L.append("")

    L.append("== phase breakdown ==")
    pb = phase_breakdown(run)
    if pb:
        for mode, ent in sorted(pb.items()):
            tot = sum(p["seconds"] for p in ent.values())
            solve = ent.get("solve", {}).get("seconds", 0.0)
            occ = solve / tot if tot > 0 else 0.0
            parts = "  ".join(
                f"{k} {p['seconds']:.3f}s/{p['calls']}"
                for k, p in sorted(ent.items()))
            L.append(f"[{mode}] {parts}  | total {tot:.3f}s "
                     f"occupancy {occ:.2f}")
    else:
        L.append("(no phase spans captured)")
    L.append("")

    L.append("== convergence trajectory ==")
    rows = iteration_rows(run)
    if rows:
        L.append(f"{'iter':>5} {'conv':>11} {'pri_rel_max':>12} "
                 f"{'s/iter':>9} {'gap_rel':>10} {'notes'}")
        shown = rows if len(rows) <= 12 else rows[:6] + rows[-6:]
        prev_it = None
        for e in shown:
            if prev_it is not None and e["iter"] != prev_it + 1:
                L.append(f"{'...':>5}")
            prev_it = e["iter"]
            notes = " ".join(f"{k.split('.')[-1]}={v}" for k, v in
                             (e.get("counter_deltas") or {}).items()
                             if not k.startswith("qp.solve_segments")
                             and not k.startswith("ph.gate_syncs"))
            L.append(f"{e['iter']:>5} {_fmt(e.get('conv')):>11} "
                     f"{_fmt(e.get('pri_rel_max')):>12} "
                     f"{_fmt(e.get('seconds'), 3):>9} "
                     f"{_fmt(e.get('gap_rel')):>10} {notes}")
    else:
        L.append("(no ph.iteration records)")
    L.append("")

    L.append("== bounds ==")
    traj = bound_trajectory(run)
    for kind in ("outer", "inner"):
        tr = traj[kind]
        if tr:
            t_first, ch, v_first = tr[0]
            t_last, ch_l, v_last = tr[-1]
            L.append(f"{kind}: {len(tr)} updates, first {_fmt(v_first)} "
                     f"[{ch}] @ {t_first:.1f}s, best {_fmt(v_last)} "
                     f"[{ch_l}] @ {t_last:.1f}s")
        else:
            L.append(f"{kind}: no updates")
    hub_it = run.of("hub.iteration")
    if hub_it:
        last = hub_it[-1]
        L.append(f"final gap: rel {_fmt(last.get('rel_gap'))} "
                 f"abs {_fmt(last.get('abs_gap'))}")
    L.append("")

    L.append("== resources ==")
    comp = compile_summary(run)
    L.append(f"XLA compiles {comp['compiles']} "
             f"(traces {comp['traces']}, "
             f"{comp['compile_seconds_total']:.2f}s total)")
    for name, n in comp["entries"][:8]:
        L.append(f"  compile x{n}: {name}")
    mems = memory_watermarks(run)
    if mems:
        for role, devs in sorted(mems.items()):
            row = "  ".join(f"{d}={_fmt_b(v)}"
                            for d, v in sorted(devs.items()))
            L.append(f"memory peak [{role or 'hub'}]: {row}")
    else:
        L.append("memory: no allocator stats "
                 "(CPU backend has none — expected off-chip)")
    c = run.counters()
    xfer = {k: v for k, v in c.items() if k.startswith("xfer.")}
    if xfer:
        L.append("transfers: " + "  ".join(
            f"{k.split('.', 1)[1]}={_fmt_b(v)}"
            for k, v in sorted(xfer.items())))
    L.append("")

    rf = roofline_summary(run)
    if rf is not None:
        L.append("== roofline ==")
        dev = rf.get("device") or {}
        if dev:
            tier = " [CPU-TIER — nominal peaks, not meaningful " \
                   "absolute utilization]" if dev.get("cpu_tier") else ""
            L.append(f"device {dev.get('device_kind')}  peaks "
                     f"{dev.get('peak_flops', 0) / 1e12:.2f} TFLOP/s / "
                     f"{dev.get('peak_hbm_gbps') or 0:.0f} GB/s "
                     f"(source {dev.get('source')}){tier}")
        ov = rf["overall"]
        if ov["iters"]:
            L.append(
                f"measured: mfu {_fmt(ov['mfu'], 4)}  hbm "
                f"{_fmt(ov['hbm_gbps'], 2)} GB/s "
                f"(util {_fmt(ov['hbm_util'], 4)})  "
                f"flops/iter {_fmt(ov['flops_total'] / ov['iters'])}  "
                f"bytes/iter "
                f"{_fmt_b(ov['hbm_bytes_total'] / ov['iters'])}  "
                f"over {ov['iters']} iter(s)")
        else:
            L.append("(no instrumented iterations — profile counters "
                     "present but no ph.iteration deltas)")
        sp = rf.get("solve_phase")
        if sp:
            L.append(f"solve-phase mfu {_fmt(sp['mfu'], 4)} "
                     f"({_fmt(sp['seconds_total'], 3)}s in solve)")
        for m, row in sorted(rf["per_mode"].items()):
            L.append(f"  mode {m}: mfu {_fmt(row['mfu'], 4)}  hbm "
                     f"{_fmt(row['hbm_gbps'], 2)} GB/s  "
                     f"{row['iters']} iter(s)")
        if rf["per_bucket"]:
            L.append("per-bucket measured vs predicted "
                     "(doc/roofline.md's est_hbm column):")
            for b in rf["per_bucket"]:
                est = b.get("est_hbm_bytes_per_iter")
                L.append(
                    f"  bucket {b['bucket']:g}: mfu {_fmt(b['mfu'], 4)}"
                    f"  hbm {_fmt(b['hbm_gbps'], 2)} GB/s "
                    f"(util {_fmt(b['hbm_util'], 4)})  measured "
                    f"{_fmt_b(b['hbm_bytes_per_iter'])}/iter"
                    + (f" vs est {_fmt_b(est)}/iter" if est else "")
                    + f"  over {b['iters']} iter(s)")
        lg = rf["ledger"]
        tick = "==" if rf["ledger_matches"] else "!="
        L.append(f"compile ledger: {rf['ledger_compiles']} compile(s) "
                 f"{tick} jax.compiles {rf['jax_compiles']}"
                 + ("" if rf["ledger_matches"] else
                    "  [MISMATCH — a compile escaped attribution]"))
        for key, ent in sorted(lg.items(),
                               key=lambda kv: -kv[1]["seconds"])[:10]:
            L.append(f"  {key}: x{ent['compiles']} "
                     f"{ent['seconds']:.2f}s")
        if rf["unavailable_count"]:
            reasons = {u.get("reason") for u in rf["unavailable"]}
            L.append(f"profile.unavailable: {rf['unavailable_count']} "
                     f"(reasons: {sorted(r for r in reasons if r)})")
        L.append("")

    sh = sharding_summary(run)
    if sh is not None:
        L.append("== sharding ==")
        L.append(f"mode {sh.get('mode')}  devices {sh.get('n_devices')}  "
                 f"shard {sh.get('shard_scenarios')} scenario(s)/device")
        per = sh.get("collective_bytes_per_iter")
        L.append(f"collective bytes: {_fmt_b(sh['collective_bytes_total'])}"
                 + (f" total, {_fmt_b(per)}/iter" if per else " total")
                 + " (psum operand estimate)")
        dp = sh.get("device_put_bytes_iterations", 0)
        L.append(f"device_put bytes: "
                 f"{_fmt_b(sh.get('device_put_bytes_total', 0))} total "
                 f"(setup placement), {_fmt_b(dp)} across iterations"
                 + ("" if dp == 0 else
                    "  [NONZERO — steady-state sharded iterations "
                    "should not device_put]"))
        L.append("")

    ck = checkpoint_summary(run)
    if ck is not None:
        L.append("== checkpoint ==")
        L.append(f"captures {ck['captures']} "
                 f"(reasons {ck['reasons'] or ['-']})  spoke-state "
                 f"writes {ck['spoke_writes']}  write failures "
                 f"{ck['write_failed']}")
        if ck.get("last_bundle"):
            L.append(f"last bundle: {ck['last_bundle']} "
                     f"(iter {ck['last_iter']})")
        if ck["resumed"]:
            r = ck.get("resume") or {}
            L.append(f"RESUMED from {r.get('bundle')} "
                     f"(iter {r.get('iter')}, outer "
                     f"{_fmt(r.get('outer'))}, inner "
                     f"{_fmt(r.get('inner'))}); spoke resumes "
                     f"{ck['spoke_resumed']}")
        if ck["rejected"]:
            L.append("rejected bundles: " + "  ".join(
                f"{k}={v}" for k, v in sorted(ck["rejected"].items()))
                + " (cold start fallback)")
        if ck["preempted"]:
            L.append("PREEMPTED: SIGTERM notice handled — final "
                     "bundle captured before terminate")
        L.append("")

    sv = serving_summary(run)
    if sv is not None:
        L.append("== serving ==")
        L.append(f"requests: {sv['admitted']} admitted  "
                 f"{sv['completed']} completed  {sv['failed']} failed  "
                 f"{sv['deadline_missed']} deadline-missed  "
                 f"{sv['rejected']} rejected  "
                 f"{sv['preempted_requests']} preempted  "
                 f"{sv['resumed']} resumed")
        ratio = sv["cache_hit_ratio"]
        L.append(f"warm cache: {sv['cache_hits']} hit(s) / "
                 f"{sv['cache_misses']} miss(es)"
                 + (f" (hit ratio {_fmt(ratio, 2)})"
                    if ratio is not None else "")
                 + f"  evictions {sv['cache_evictions']}")
        L.append(f"wheels: {sv['wheels']} total  "
                 f"{sv['stacked_wheels']} stacked "
                 f"({sv['coalesced']} requests coalesced)  "
                 f"chain steps {sv['chain_steps']}")
        occ = sv.get("batch_occupancy")
        if occ:
            L.append(f"batch occupancy: mean "
                     f"{_fmt(occ.get('mean'), 2)}  max "
                     f"{_fmt(occ.get('max'), 0)}  over "
                     f"{int(occ.get('count', 0))} wheel(s)")
        if sv["per_bucket_compiles"]:
            L.append("per-bucket compiles: " + "  ".join(
                f"{k}={v}" for k, v in
                sorted(sv["per_bucket_compiles"].items())))
        if sv["service_preempted"]:
            L.append("SERVICE PREEMPTED: in-flight wheels "
                     "checkpointed; requests resume at next start")
        if sv.get("quarantined"):
            L.append(f"QUARANTINED: {sv['quarantined']} request(s) "
                     "failed after exhausting --max-recoveries "
                     "(poison pill suspected)")
        mig = sv.get("migration")
        if mig is not None:
            L.append(f"migration: {mig['offered']} offered  "
                     f"{mig['handed_off']} handed off  "
                     f"{mig['committed']} committed  "
                     f"{mig['completed']} completed"
                     + ("  [drained]" if sv.get("drained") else ""))
            if mig["aborted"]:
                L.append("  aborted: " + "  ".join(
                    f"{k}={v}" for k, v in sorted(mig["aborted"].items())))
            if mig["rejected"]:
                L.append("  rejected by receiver: " + "  ".join(
                    f"{k}={v}" for k, v in
                    sorted(mig["rejected"].items())))
            if not mig["reconciled"]:
                L.append("  LEDGER MISMATCH: offered != handed_off + "
                         "aborted — an offer path returned without "
                         "booking its outcome (doc/serving.md)")
        L.append("")

    shr = shrink_summary(run)
    if shr is not None:
        L.append("== shrinking ==")
        L.append(f"fixed {shr['fixed_final']} / free {shr['free_final']}"
                 f"  (+{shr['fixed_new_total']} fixed over the run)  "
                 f"compactions {shr['compactions']}"
                 + (f" (skipped {shr['compaction_skipped']})"
                    if shr['compaction_skipped'] else "")
                 + f"  rho updates {shr['rho_updates']}")
        if shr["compactions"]:
            L.append(f"bucket compiles {shr['bucket_compiles']}  "
                     f"bucket cache hits {shr['bucket_cache_hits']}")
            for e in shr["compaction_events"]:
                L.append(f"  iter {e['iter']}: bucket {e['bucket']:g} "
                         f"-> {e['n_cols']}/{e['n_full']} cols, "
                         f"{e['m_rows']}/{e['m_full']} rows"
                         + (" [cached]" if e.get("bucket_cached")
                            else ""))
        if shr["transplants"] or shr["transplant_cold_fallbacks"]:
            L.append(f"cross-bucket transplants {shr['transplants']}  "
                     "cold fallbacks "
                     f"{shr['transplant_cold_fallbacks']}")
        if shr["reconvergence"]:
            L.append("post-transition re-convergence "
                     "(iterations back to the pre-transition conv):")
            for r in shr["reconvergence"]:
                k = r["iters_to_reconverge"]
                L.append(
                    f"  bucket {r['bucket']:g} (iter {r['iter']}, "
                    f"{r['mode']}): "
                    + (f"{k} iter(s)" if k is not None else
                       "not recovered in the record"))
        if shr["per_bucket"]:
            L.append("per-bucket s/iter (active-set verdict source):")
            for b in shr["per_bucket"]:
                hbm = b.get("est_hbm_bytes_per_iter")
                L.append(f"  bucket {b['bucket']:g}: "
                         f"{_fmt(b['s_per_iter'], 4)} s/iter over "
                         f"{b['iters']} iter(s)"
                         + (f", est HBM {_fmt_b(hbm)}/iter"
                            if hbm else ""))
        tr = [t for t in shr["trajectory"]
              if t.get("fixed") is not None]
        if tr:
            L.append("fixed-fraction trajectory (iter: fixed/free): "
                     + "  ".join(f"{t['iter']}: {t['fixed']}/{t['free']}"
                                 for t in tr[-8:]))
        L.append("")

    stm = streaming_summary(run)
    if stm is not None:
        L.append("== streaming ==")
        occ = stm["prefetch_occupancy"]
        L.append(f"source {stm['source'] or '?'}  chunks shipped "
                 f"{stm['chunks_shipped']} ({_fmt_b(stm['bytes_shipped'])})"
                 f"  synthesized {stm['synth_chunks']}  direct fetches "
                 f"{stm['direct_fetches']}")
        L.append(f"prefetch stalls {stm['prefetch_stalls']}"
                 + (f"  occupancy {_fmt(occ, 3)}" if occ is not None
                    else "")
                 + f"  int8 fallbacks {stm['int8_fallbacks']}")
        if stm["compacted_transitions"]:
            L.append(f"compacted re-blocks "
                     f"{stm['compacted_transitions']}  (out-of-band "
                     f"restage "
                     f"{_fmt_b(stm['compacted_restage_bytes'])}; "
                     "steady state judged after the last transition)")
        flat = stm["device_put_flat_steady_state"]
        if flat is not None:
            L.append("steady-state device_put: "
                     + ("FLAT (the streaming acceptance contract)"
                        if flat else
                        "NOT FLAT — per-iteration transfer grew or "
                        "leaked (see per_iteration in --json)"))
        L.append("")

    ap = aph_summary(run)
    if ap is not None:
        L.append("== aph ==")
        sav = ap["skipped_solve_savings"]
        L.append(f"dispatch_frac {_fmt(ap['dispatch_frac'], 3)}  "
                 f"path {ap['solve_path'] or '?'}  solved "
                 f"{ap['solved_scenarios']}  skipped "
                 f"{ap['skipped_scenarios']}"
                 + (f"  (savings {_fmt(sav, 3)})"
                    if sav is not None else ""))
        gpi = ap["gate_syncs_per_iteration"]
        L.append(f"gate syncs {ap['gate_syncs']}"
                 + (f"  ({_fmt(gpi, 2)}/iter — the stacked-gate "
                    "contract says 1)" if gpi is not None else "")
                 + f"  bucket compiles {ap['bucket_compiles']}  "
                 f"bucket cache hits {ap['bucket_cache_hits']}")
        tr = [t for t in ap["trajectory"]
              if t.get("dispatched") is not None]
        if tr:
            L.append("dispatched trajectory (iter: n/S φneg): "
                     + "  ".join(
                         f"{t['iter']}: {t['dispatched']}/{t['S_real']} "
                         f"{t['phi_neg']}" for t in tr[-8:]))
        L.append("")

    inc = incumbent_summary(run)
    if inc is not None:
        L.append("== incumbent ==")
        L.append(f"pool rounds {inc['rounds']}  pool size "
                 f"{inc['pool_size']}  candidates "
                 f"{inc['candidates_evaluated']} ({inc['feasible']} "
                 f"feasible)  improvements {inc['improvements']} "
                 f"(accept rate {_fmt(inc['accept_rate'], 2)})")
        L.append(f"pool reuse skips {inc['pool_reused']}  oracle "
                 f"polish {inc['oracle_polish']}  gate syncs "
                 f"{inc['gate_syncs']}")
        traj = [t for t in inc["trajectory"]
                if t.get("best") is not None]
        if traj:
            L.append("best-value trajectory (round: best): "
                     + "  ".join(f"{t['round']}: {_fmt(t['best'], 2)}"
                                 for t in traj[-6:]))
        L.append("")

    L.append("== counters ==")
    for k in sorted(c):
        if k.split(".")[0] in ("ph", "qp", "hub", "spoke", "incumbent",
                               "serve", "shrink", "stream", "aph",
                               "dispatch"):
            L.append(f"  {k} = {_fmt(c[k])}")
    L.append("")

    L.append("== faults ==")
    f = fault_summary(run)
    if not f["degraded"]:
        L.append("(none — no spoke downs, respawns, quarantines, "
                 "rejected payloads, or watchdog)")
    else:
        L.append(f"DEGRADED RUN: {f['downs']} down(s), "
                 f"{f['respawns']} respawn(s), "
                 f"{f['quarantined']} quarantined, "
                 f"{f['rejected_payloads']} rejected payload(s) "
                 f"({f['crossed_rejections']} crossed)")
        for key, ent in sorted(f["per_spoke"].items()):
            reasons = f" [{', '.join(ent['reasons'])}]" \
                if ent["reasons"] else ""
            L.append(f"  {key}: downs {ent['downs']} "
                     f"respawns {ent['respawns']} "
                     f"quarantined {ent['quarantined']} "
                     f"rejected {ent['rejected']}{reasons}")
        if f["watchdog_fired"]:
            w = f["watchdog"] or {}
            L.append(f"  watchdog fired: source {w.get('source', '?')} "
                     f"after {_fmt(w.get('elapsed'))}s "
                     f"(partial bounds outer {_fmt(w.get('outer'))} / "
                     f"inner {_fmt(w.get('inner'))})")
    L.append("")

    bf = bound_flow_summary(run)
    if bf is not None:
        L.append("== bound flow ==")
        for label, ent in bf.items():
            kind = f" [{ent['kind']}]" if ent.get("kind") else ""
            stal = ""
            if ent.get("staleness_p50") is not None:
                stal = (f"  staleness p50 {_fmt(ent['staleness_p50'], 2)}s"
                        f" p99 {_fmt(ent.get('staleness_p99'), 2)}s")
            cad = ""
            if ent.get("publish_interval_p50") is not None:
                cad = (f"  cadence p50 "
                       f"{_fmt(ent['publish_interval_p50'], 2)}s")
            why = f" ({ent['why']})" if ent.get("why") else ""
            L.append(
                f"  {label}{kind}: produced "
                f"{ent.get('produced', ent.get('published', 0))} "
                f"consumed {ent.get('consumed', 0)} "
                f"lag {ent.get('lag', 0)}  accepted "
                f"{ent.get('accepted', 0)} rejected "
                f"{ent.get('rejected', 0)}{stal}{cad}  -> "
                f"{ent['verdict']}{why}")
        L.append("")

    fo = forensics_summary(run)
    if fo is not None:
        # ranked diagnosis (ops/forensics.py + obs/diagnose.py,
        # doc/forensics.md): verdicts most-severe first, then the last
        # sample's culprit leaderboards
        L.append("== forensics ==")
        L.append(f"verdict: {fo['verdict']}  (samples {fo['samples']}, "
                 f"bound checks {fo['bound_checks']})")
        for v in fo["verdicts"]:
            L.append(f"  [{v['verdict']}] {v['summary']}"
                     + (f" — advice: {v['advice']}"
                        if v.get("advice") else ""))
        last = fo.get("last")
        if last:
            slots = last.get("top_slots") or []
            if slots:
                L.append("top culprit slots (slot: |x-xbar| mass): "
                         + "  ".join(f"{int(s)}: {_fmt(m)}"
                                     for s, m in slots[:5]))
            scens = last.get("scen_pri_shares") or []
            if scens:
                L.append("scenario residual shares (scen: share): "
                         + "  ".join(f"{int(s)}: {_fmt(sh, 3)}"
                                     for s, sh in scens[:5]))
            L.append(f"osc_mean {_fmt(last.get('osc_mean'), 3)}  "
                     f"rho log-ratio "
                     f"{_fmt(last.get('rho_log_ratio_mean'), 3)}  "
                     f"xbar move {_fmt(last.get('xbar_move'))}")
        for v in fo["verdict_events"][-4:]:
            L.append(f"  verdict event @iter {v.get('it')}: "
                     f"{v.get('prev')} -> {v.get('verdict')}")
        L.append("")

    L.append("== invariant checks ==")
    for name, ok, detail, severity in invariant_checks(run,
                                                       bound_flow=bf):
        tag = "PASS" if ok else severity.upper()
        L.append(f"  [{tag}] {name}: {detail}")
    text = "\n".join(L)
    return _stamp_truncated(text) if trunc else text


# ---------------- compare ----------------

# (metric, kind): kind "time" uses the time threshold + an absolute
# floor (sub-millisecond jitter is not a regression), kind "count"
# uses a fixed 1.25x ratio gate
_ABS_FLOOR_S = 1e-3


def comparison_metrics(run: Run) -> dict:
    out = {}
    rows = iteration_rows(run)
    secs = [e["seconds"] for e in rows if
            isinstance(e.get("seconds"), (int, float))]
    if secs:
        out[("ph_seconds_per_iteration", "time")] = sum(secs) / len(secs)
    for mode, ent in phase_breakdown(run).items():
        for ph, p in ent.items():
            if p["calls"]:
                out[(f"phase_{ph}_seconds_per_call[{mode}]", "time")] = \
                    p["seconds"] / p["calls"]
    c = run.counters()
    calls = c.get("ph.solve_loop_calls", 0)
    if calls:
        out[("gate_syncs_per_solve_call", "count")] = \
            c.get("ph.gate_syncs", 0) / calls
        # ABSOLUTE compile count, not per-solve-call: compiles are
        # per-process structural cost (cold-start + retraces) while
        # solve-call counts jitter with async wheel timing, so the
        # ratio of the two flakes across identical trees. A retrace
        # regression moves the absolute count directly.
        out[("xla_compiles_total", "count")] = c.get("jax.compiles", 0)
        # sharded runs: collective traffic per solve call and
        # steady-state device_put leakage — a sharded-vs-sharded
        # compare flags a collective-volume or placement regression;
        # keys absent on unsharded runs are skipped by compare()
        if "xfer.collective_bytes" in c:
            out[("collective_kbytes_per_solve_call", "count")] = \
                c["xfer.collective_bytes"] / 1024.0 / calls
            sh = sharding_summary(run)
            if sh is not None:
                out[("device_put_kbytes_across_iterations", "count")] = \
                    sh.get("device_put_bytes_iterations", 0) / 1024.0
    h = run.histograms().get("ph.iteration_seconds", {})
    if h.get("p99") is not None:
        out[("ph_iteration_seconds_p99", "time")] = h["p99"]
    if calls and "kernel.fused_iters" in c:
        # fused-vs-fused pairings compare kernel iteration volume too
        # (a jump means the fused programs are burning more budget for
        # the same work); fused-vs-segmented pairings skip this row —
        # the dedicated verdict row in compare() handles those
        out[("kernel_fused_iters_per_solve_call", "count")] = \
            c["kernel.fused_iters"] / calls
    if calls and "stream.bytes_shipped" in c:
        # streamed runs (doc/streaming.md): shipped volume
        # per solve call — a streamed-vs-streamed compare flags a
        # staging regression (e.g. an int8 field regressing to f64, or
        # a third restage pass sneaking into the iteration); absent on
        # resident/synthesized runs, skipped by compare()
        out[("stream_kbytes_per_solve_call", "count")] = \
            c["stream.bytes_shipped"] / 1024.0 / calls
    return out


def kernel_summary(run: Run) -> dict:
    """Kernel-backend activity of one run (the ops/kernels counters,
    doc/kernels.md): which subproblem kernel mode actually executed and
    the trade volumes the fused-vs-segmented compare row reports."""
    c = run.counters()
    calls = c.get("ph.solve_loop_calls", 0)
    fused = c.get("kernel.fused_iters", 0)
    return {
        "mode": "fused" if fused else "segmented",
        "fused_iters": fused,
        "fused_iters_per_solve_call": (fused / calls) if calls else 0.0,
        "l_inv_factorizations": c.get("kernel.l_inv_factorizations", 0),
        "bf16_fallbacks": c.get("kernel.bf16_fallbacks", 0),
    }


def compare(a: Run, b: Run, threshold=1.5,
            abs_floor=_ABS_FLOOR_S) -> tuple[str, bool]:
    """Render the A-vs-B diff; returns (text, passed). Raises
    ValueError on a schema mismatch — two formats must not be
    numerically compared.

    ``abs_floor`` (seconds) suppresses time-metric verdicts whose
    absolute delta is below it: micro-phases (sub-ms per call) ride
    scheduler noise, so a 3x ratio on 0.5 ms is jitter, not a
    regression. Same-machine compares keep the tight 1 ms default;
    cross-machine gates (tools/regression_gate.py) pass a looser
    floor."""
    if a.schema != b.schema:
        raise ValueError(
            f"schema mismatch: {a.path} is v{a.schema}, {b.path} is "
            f"v{b.schema} — re-run one side or analyze separately "
            "(refusing to mis-parse)")
    ma, mb = comparison_metrics(a), comparison_metrics(b)
    trunc = [t for t, r in (("A", a), ("B", b)) if truncated(r)]
    L = [f"== compare ==\nA: {a.path}\nB: {b.path}\n"
         f"time regression threshold: {threshold:.2f}x "
         f"(abs floor {abs_floor * 1e3:.0f} ms)"]
    if trunc:
        L.append(f"TRUNCATED RUN ({', '.join(trunc)}): no run_footer — "
                 "that side was killed before shutdown; every section "
                 "below compares against its last flushed events, not "
                 "a completed run")
    regressions = []
    for key in sorted(set(ma) & set(mb), key=lambda k: k[0]):
        name, kind = key
        va, vb = ma[key], mb[key]
        ratio = (vb / va) if va > 0 else (math.inf if vb > 0 else 1.0)
        if kind == "time":
            bad = ratio > threshold and (vb - va) > abs_floor
            better = ratio < 1.0 / threshold and (va - vb) > abs_floor
        else:
            bad = ratio > 1.25 and (vb - va) > 0.5
            better = ratio < 0.8 and (va - vb) > 0.5
        tag = ("REGRESSION" if bad else
               "improved" if better else "ok")
        if bad:
            regressions.append(name)
        L.append(f"  {name}: A={_fmt(va)} B={_fmt(vb)} "
                 f"ratio={_fmt(ratio, 3)} [{tag}]")
    ka, kb = kernel_summary(a), kernel_summary(b)
    if ka["fused_iters"] or kb["fused_iters"]:
        # fused-vs-segmented verdict row (doc/kernels.md):
        # when the two runs executed different subproblem kernel modes,
        # the per-iteration time rows above ARE the evidence — restate
        # them against the kernel modes so the pairing reads as one
        # explicit accept/reject line, not a diff to interpret.
        per_iter_bad = [r for r in regressions
                        if r.startswith(("ph_seconds_per_iteration",
                                         "ph_iteration_seconds",
                                         "phase_solve"))]
        tag = "REGRESSION" if per_iter_bad else "PASS"
        L.append(
            f"  kernel: A={ka['mode']} "
            f"({_fmt(ka['fused_iters_per_solve_call'])} fused "
            f"iters/solve, l_inv={ka['l_inv_factorizations']}, "
            f"bf16_fallbacks={ka['bf16_fallbacks']}) "
            f"B={kb['mode']} "
            f"({_fmt(kb['fused_iters_per_solve_call'])}, "
            f"l_inv={kb['l_inv_factorizations']}, "
            f"bf16_fallbacks={kb['bf16_fallbacks']}) — "
            f"per-iteration verdict [{tag}]")
    # streaming verdict row (doc/streaming.md): for a run
    # with an active scenario source, the acceptance contract is FLAT
    # steady-state device_put deltas — restate each side's flatness +
    # staging anatomy as one explicit line; a side whose steady-state
    # transfer grew books a regression.
    for tag, run_ in (("A", a), ("B", b)):
        sm = streaming_summary(run_)
        if sm is None:
            continue
        flat = sm["device_put_flat_steady_state"]
        verdict = "PASS"
        if flat is False:
            verdict = "REGRESSION"
            regressions.append(f"stream_flat_device_put[{tag}]")
        occ = sm["prefetch_occupancy"]
        L.append(
            f"  stream[{tag}]: source={sm['source'] or '?'} "
            f"shipped={_fmt_b(sm['bytes_shipped'])} "
            f"synth_chunks={sm['synth_chunks']} "
            f"int8_fallbacks={sm['int8_fallbacks']}"
            + (f" occupancy={_fmt(occ, 3)}" if occ is not None else "")
            + f" — steady-state device_put verdict [{verdict}]")
    # APH dispatch verdict row (doc/aph.md): at EQUAL
    # dispatch_frac, the φ-dispatch promise is that B launches no more
    # scenario-solves per iteration than A — a grown count means the
    # skip machinery silently degraded to full-width launches (the
    # exact regression the counter exists to catch). Different fracs
    # are a config change, not a regression; the row says so and
    # abstains.
    apa, apb = aph_summary(a), aph_summary(b)
    if apa is not None and apb is not None:
        va = apa.get("solved_per_iteration")
        vb = apb.get("solved_per_iteration")
        fa, fb = apa.get("dispatch_frac"), apb.get("dispatch_frac")
        if fa is not None and fb is not None and fa != fb:
            L.append(f"  aph: dispatch_frac differs (A={_fmt(fa, 3)} "
                     f"B={_fmt(fb, 3)}) — dispatch verdict [skipped]")
        elif va is not None and vb is not None:
            verdict = "PASS"
            if vb > va + 0.5:
                verdict = "REGRESSION"
                regressions.append("aph_dispatched_solves")
            L.append(
                f"  aph: solved/iter A={_fmt(va)} B={_fmt(vb)} "
                f"(frac {_fmt(fa, 3)})  gate syncs/iter "
                f"A={_fmt(apa['gate_syncs_per_iteration'], 2)} "
                f"B={_fmt(apb['gate_syncs_per_iteration'], 2)} — "
                f"dispatch verdict [{verdict}]")
    # per-iteration-time-vs-active-set verdict row (
    # doc/extensions.md §shrinking): for a run with compactions, the
    # shrinking promise is that post-compaction iterations get
    # CHEAPER as the active set shrinks — restate each side's
    # per-bucket s/iter as one explicit line. A side whose
    # last-bucket mean runs >1.5x its bucket-0 mean (over the abs
    # floor) broke the promise and books a regression.
    sha = shb = None
    for tag, run_ in (("A", a), ("B", b)):
        sh = shrink_summary(run_)
        if tag == "A":
            sha = sh
        else:
            shb = sh
        if sh is None or not sh.get("per_bucket"):
            continue
        pb = sh["per_bucket"]
        head, tail = pb[0], pb[-1]
        line = "  ".join(
            f"bucket {r['bucket']:g}={_fmt(r['s_per_iter'], 4)}s/iter"
            f"({r['iters']})" for r in pb)
        verdict = "PASS"
        if len(pb) > 1 and tail["s_per_iter"] > head["s_per_iter"] \
                * threshold \
                and (tail["s_per_iter"] - head["s_per_iter"]) \
                > abs_floor:
            verdict = "REGRESSION"
            regressions.append(f"shrink_active_set[{tag}]")
        if len(pb) > 1:
            line += (f" — active-set verdict [{verdict}] "
                     f"(compactions {sh['compactions']})")
        L.append(f"  shrink[{tag}]: {line}")
    # transplant verdict row (doc/extensions.md §shrinking):
    # at an EQUAL bucket schedule (the same compaction sequence ran on
    # both sides), the cross-bucket transplant promise is that B's
    # guarded cold restarts did not grow — a grown count means warm
    # states stopped surviving the transition (width-mismatch, dirty
    # donated passes, lost source factors: exactly the silent decay
    # the counter exists to catch). Different schedules are a config
    # change, not a regression; the row says so and abstains.
    if sha is not None and shb is not None:
        sched_a = [e.get("bucket") for e in sha["compaction_events"]]
        sched_b = [e.get("bucket") for e in shb["compaction_events"]]
        ca = sha["transplant_cold_fallbacks"]
        cb = shb["transplant_cold_fallbacks"]
        if sched_a and sched_a != sched_b:
            L.append(f"  transplant: bucket schedule differs "
                     f"(A={sched_a} B={sched_b}) — cold-fallback "
                     "verdict [skipped]")
        elif sched_a and (sha["transplants"] or ca
                          or shb["transplants"] or cb):
            verdict = "PASS"
            if cb > ca:
                verdict = "REGRESSION"
                regressions.append("shrink_transplant_cold_fallbacks")
            L.append(
                f"  transplant: warm A={sha['transplants']} "
                f"B={shb['transplants']}  cold A={ca} B={cb} — "
                f"cold-fallback verdict [{verdict}]")
    # measured-MFU verdict row (doc/roofline.md): when both
    # sides carry profile captures, the roofline promise is that B's
    # measured model-FLOP utilization did not collapse — the per-
    # iteration time rows can stay flat while the work per iteration
    # silently grew (shape-bucket drift, fallback kernels), and MFU is
    # the one figure that catches it. A >1.25x drop with a real
    # absolute delta books a regression; one-sided captures abstain,
    # and so do runs whose FLOPs/iter differ materially — different
    # arithmetic per iteration (e.g. segmented vs fused engines)
    # makes MFU apples-to-oranges, not a regression.
    ra, rb = roofline_summary(a), roofline_summary(b)
    if ra is not None and rb is not None:
        va = ra["overall"]["mfu"]
        vb = rb["overall"]["mfu"]

        def _fpi(r):
            o = r["overall"]
            return o["flops_total"] / o["iters"] if o["iters"] else 0.0

        fa, fb = _fpi(ra), _fpi(rb)
        same_work = (fa > 0 and fb > 0
                     and 0.9 < fa / fb < 1.1111)
        if va is not None and vb is not None and va > 0:
            verdict = "PASS" if same_work else "skipped"
            if same_work and (vb <= 0 or (va / max(vb, 1e-12) > 1.25
                                          and (va - vb) > 1e-4)):
                verdict = "REGRESSION"
                regressions.append("profile_mfu")
            L.append(
                f"  roofline: mfu A={_fmt(va, 4)} B={_fmt(vb, 4)}  "
                f"hbm A={_fmt(ra['overall']['hbm_gbps'], 2)} "
                f"B={_fmt(rb['overall']['hbm_gbps'], 2)} GB/s  "
                f"compiles A={ra['ledger_compiles']} "
                f"B={rb['ledger_compiles']} — MFU verdict [{verdict}]")
    elif ra is not None or rb is not None:
        L.append("  roofline: profile captures on one side only — "
                 "MFU verdict [skipped]")
    # forensics verdict row (doc/forensics.md): when a side
    # carries forensic data, restate its diagnosis as one explicit
    # line. A candidate whose wheel shows a stall signature the
    # baseline lacks books a regression — a faster wheel that stopped
    # converging is not an improvement; sides without forensic data
    # abstain (runs predating the layer).
    fza, fzb = forensics_summary(a), forensics_summary(b)
    if fza is not None or fzb is not None:
        va = fza["verdict"] if fza else None
        vb = fzb["verdict"] if fzb else None
        verdict = "PASS" if (fza is not None and fzb is not None) \
            else "skipped"
        if fzb is not None and vb != "HEALTHY" \
                and (fza is None or va == "HEALTHY"):
            verdict = "REGRESSION"
            regressions.append(f"forensics_{vb.lower()}")
        why = ""
        if fzb is not None and fzb["verdicts"]:
            why = f" (B: {fzb['verdicts'][0]['summary']})"
        L.append(f"  forensics: A={va or 'n/a'} B={vb or 'n/a'}{why} "
                 f"— stall verdict [{verdict}]")
    only = [k[0] for k in (set(ma) ^ set(mb))]
    if only:
        L.append(f"  (not in both runs, skipped: {sorted(only)})")
    passed = not regressions
    L.append(f"VERDICT: {'PASS' if passed else 'REGRESSION'}"
             + (f" ({', '.join(regressions)})" if regressions else ""))
    text = "\n".join(L)
    return (_stamp_truncated(text) if trunc else text), passed


# ---------------- watch (the live tail) ----------------

def _rel_age(now, wall):
    if not isinstance(wall, (int, float)):
        return "?"
    return f"{max(0.0, now - wall):.1f}s ago"


def render_watch(path) -> tuple[str, bool]:
    """One refresh frame of ``analyze --watch``: the live.json snapshot
    the hub atomically rewrites on every termination check, plus the
    tail of the event streams. Returns (frame, done) — done once a
    ``run_footer`` has landed (the run is over; the next refresh would
    show the same thing forever)."""
    import time

    now = time.time()
    L = [f"== live wheel == {path}"]
    live = None
    lp = os.path.join(path, "live.json")
    if os.path.exists(lp):
        try:
            with open(lp, encoding="utf-8") as fh:
                live = json.load(fh)
        except ValueError:
            live = None     # racing the atomic replace; next tick wins
    if live is not None:
        L.append(
            f"run {live.get('run_id')}  iter {live.get('iter')}  "
            f"updated {_rel_age(now, live.get('wall_time_unix'))}"
            + ("  [WATCHDOG FIRED]" if live.get("watchdog_fired")
               else ""))
        L.append(
            f"outer {_fmt(live.get('outer'), 8)} "
            f"[{live.get('ob_char', ' ')}]  "
            f"inner {_fmt(live.get('inner'), 8)} "
            f"[{live.get('ib_char', ' ')}]  "
            f"rel gap {_fmt(live.get('rel_gap'))}  "
            f"elapsed {_fmt(live.get('elapsed_seconds'), 4)}s")
        ph = live.get("phases")
        if ph:
            L.append(f"phases [{ph.get('mode')}] occupancy "
                     f"{_fmt(ph.get('occupancy'), 3)}  s/call "
                     + "  ".join(f"{k} {_fmt(v, 3)}" for k, v in
                                 (ph.get("seconds_per_call")
                                  or {}).items()))
        rf = live.get("roofline")
        if rf:
            # current-iteration measured roofline (obs/profile.py):
            # one line — MFU + HBM utilization of the last completed
            # iteration, straight off the live plane
            L.append(
                f"roofline iter {rf.get('iter')}: "
                f"mfu {_fmt(rf.get('mfu'), 4)}  "
                f"hbm {_fmt(rf.get('hbm_gbps'), 2)} GB/s "
                f"(util {_fmt(rf.get('hbm_util'), 4)})  "
                f"flops/iter {_fmt(rf.get('flops_per_iter'))}")
        fo = live.get("forensics")
        if fo:
            # wheel-forensics tile (obs/diagnose.py): the current
            # verdict + top culprit slot/scenario, straight off the
            # live plane (doc/forensics.md)
            L.append(
                f"forensics {fo.get('verdict', '?')}: "
                f"top slot {fo.get('top_slot')} "
                f"(mass {_fmt(fo.get('top_slot_mass'))})  "
                f"top scen {fo.get('top_scen')} "
                f"(share {_fmt(fo.get('top_scen_share'), 3)})  "
                f"samples {fo.get('samples', 0)}")
        for sp in live.get("spokes", ()):
            flags = []
            if sp.get("alive") is False:
                flags.append("DEAD")
            if sp.get("crashes"):
                flags.append(f"crashes {sp['crashes']}")
            stal = sp.get("staleness_last_seconds")
            L.append(
                f"  spoke{sp.get('index')} "
                f"[{sp.get('kind') or sp.get('spoke', '?')}] "
                f"{sp.get('state', '?')} gen {sp.get('gen', 0)}  "
                f"produced {sp.get('produced', 0)} consumed "
                f"{sp.get('consumed', 0)} lag {sp.get('lag', 0)}  "
                f"accepted {sp.get('accepted', 0)} rejected "
                f"{sp.get('rejected', 0)}"
                + (f"  staleness {_fmt(stal, 2)}s"
                   if stal is not None else "")
                + ("  " + " ".join(flags) if flags else ""))
    else:
        L.append("(no live.json yet — hub has not reached a "
                 "termination check, or the run predates the live "
                 "plane)")
    # event tail across every role stream, newest last
    tail = []
    done = False
    for f in glob.glob(os.path.join(path, "events*.jsonl")):
        role = _role_of(f, "events", ".jsonl")
        try:
            # bounded tail read: the hub stream grows every termination
            # check, and --watch re-renders every ~2 s — reading whole
            # multi-hour files each frame would peg IO on the machine
            # hosting the run this view is meant to observe passively
            with open(f, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - 65536))
                chunk = fh.read().decode("utf-8", "replace")
            lines = chunk.splitlines()[-40:]
        except OSError:
            continue
        for ln in lines:
            try:
                e = json.loads(ln)
            except ValueError:
                continue
            if e.get("type") == "run_footer" and role == "":
                done = True
            tail.append((e.get("t", 0.0), role, e))
    tail.sort(key=lambda t: t[0])
    L.append("recent events:")
    for t, role, e in tail[-8:]:
        fields = " ".join(
            f"{k}={_fmt(v) if isinstance(v, float) else v}"
            for k, v in e.items()
            if k not in ("t", "type", "_role", "config", "metrics")
            and not isinstance(v, (dict, list)))
        L.append(f"  [{role or 'hub':>18}] {e.get('type')} "
                 f"{fields[:120]}")
    if done:
        L.append("(run complete — footer landed; watch exiting. "
                 "Run `analyze` on the dir for the full report.)")
    return "\n".join(L), done


def watch(path, interval=2.0, refreshes=None) -> int:
    """Refreshing terminal view of a live run directory: tail
    live.json + events.jsonl until the run footer lands (or
    ``refreshes`` frames for tests / one-shot peeks)."""
    import time

    n = 0
    while True:
        frame, done = render_watch(path)
        # ANSI clear + home; falls out harmlessly on dumb terminals
        print("\x1b[2J\x1b[H" + frame, flush=True)
        n += 1
        if done or (refreshes is not None and n >= refreshes):
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


# ---------------- CLI ----------------

def _json_sanitize(o):
    """Non-finite floats → None, recursively. Default ``json.dumps``
    serializes them as bare ``NaN``/``Infinity`` — a JavaScript
    extension, not JSON, so strict downstream parsers reject the whole
    document. Applied at the ``--json`` emit boundary (pinned by a
    ``parse_constant``-raising round-trip test)."""
    if isinstance(o, float):
        return o if math.isfinite(o) else None
    if isinstance(o, dict):
        return {k: _json_sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_json_sanitize(v) for v in o]
    return o


def make_parser():
    p = argparse.ArgumentParser(
        prog="python -m mpisppy_tpu_torch analyze",
        description="Render a diagnostics report from a --telemetry-dir "
                    "run directory, or diff two runs.")
    p.add_argument("dirs", nargs="*",
                   help="one telemetry dir (report) — or two with "
                        "--compare")
    p.add_argument("--compare", action="store_true",
                   help="diff two runs: analyze --compare A B")
    p.add_argument("--watch", action="store_true",
                   help="live mode: refreshing terminal view tailing "
                        "the dir's live.json + events.jsonl while the "
                        "run iterates (exits when the run footer "
                        "lands)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch refresh seconds (default 2)")
    p.add_argument("--refreshes", type=int, default=None,
                   help="--watch: stop after N frames (default: until "
                        "the run ends)")
    p.add_argument("--threshold", type=float, default=1.5,
                   help="time-metric regression ratio (default 1.5)")
    p.add_argument("--abs-floor-ms", type=float,
                   default=_ABS_FLOOR_S * 1e3,
                   help="ignore time-metric deltas below this many ms "
                        "per call/iteration (default 1 — raise for "
                        "cross-machine compares where micro-phase "
                        "timings are scheduler noise)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    try:
        if args.watch:
            if len(args.dirs) != 1:
                print("analyze --watch needs exactly one telemetry dir")
                return 2
            return watch(args.dirs[0], interval=args.interval,
                         refreshes=args.refreshes)
        if args.compare:
            if len(args.dirs) != 2:
                print("analyze --compare needs exactly two telemetry "
                      "dirs")
                return 2
            a, b = load_run(args.dirs[0]), load_run(args.dirs[1])
            try:
                text, passed = compare(
                    a, b, threshold=args.threshold,
                    abs_floor=args.abs_floor_ms / 1e3)
            except ValueError as e:
                print(f"analyze: {e}")
                return 2
            if args.as_json:
                print(json.dumps(_json_sanitize(
                    {"a": {str(k[0]): v
                           for k, v in comparison_metrics(a).items()},
                     "b": {str(k[0]): v
                           for k, v in comparison_metrics(b).items()},
                     "kernel": {"a": kernel_summary(a),
                                "b": kernel_summary(b)},
                     "shrink": {"a": shrink_summary(a),
                                "b": shrink_summary(b)},
                     "streaming": {"a": streaming_summary(a),
                                   "b": streaming_summary(b)},
                     "aph": {"a": aph_summary(a),
                             "b": aph_summary(b)},
                     "roofline": {"a": roofline_summary(a),
                                  "b": roofline_summary(b)},
                     "forensics": {"a": forensics_summary(a),
                                   "b": forensics_summary(b)},
                     "truncated": {"a": truncated(a),
                                   "b": truncated(b)},
                     "verdict": "PASS" if passed else "REGRESSION"})))
            else:
                print(text)
            return 0 if passed else 3
        if len(args.dirs) != 1:
            make_parser().print_usage()
            return 2
        run = load_run(args.dirs[0])
        if args.as_json:
            print(json.dumps(_json_sanitize({
                "run_id": run.header.get("run_id"),
                "schema": run.schema,
                "phase_breakdown": phase_breakdown(run),
                "iterations": iteration_rows(run),
                "counters": run.counters(),
                "memory": memory_watermarks(run),
                "compile": {k: v for k, v in compile_summary(run).items()
                            if k != "entries"},
                "sharding": sharding_summary(run),
                "roofline": roofline_summary(run),
                "truncated": truncated(run),
                "shrink": shrink_summary(run),
                "streaming": streaming_summary(run),
                "aph": aph_summary(run),
                "incumbent": incumbent_summary(run),
                "checkpoint": checkpoint_summary(run),
                "serving": serving_summary(run),
                "faults": fault_summary(run),
                "forensics": forensics_summary(run),
                "lint": lint_summary(run),
                "bound_flow": (bf := bound_flow_summary(run)),
                "invariants": [
                    {"name": n, "ok": ok, "detail": d, "severity": sv}
                    for n, ok, d, sv in invariant_checks(
                        run, bound_flow=bf)],
            })))
        else:
            print(render_report(run))
        return 0
    except FileNotFoundError as e:
        print(f"analyze: {e}")
        return 2
