"""Rank programs of the port's mesh tests (tests/test_torch_mesh.py and
tests/test_torch_sharding.py), run by mpisppy_tpu_torch.parallel.launch
on gloo CPU ranks. Spawned ranks import this module, so it imports the
port only (never jax). Every program takes the rank's mesh (None runs
the unsharded engine in the calling process) and returns host values:
every per-scenario array is every rank's rows, pads included.
"""

import numpy as np
import torch

_UC_KW = {"num_gens": 3, "num_hours": 6}
UC_FULL = {"num_gens": 6, "num_hours": 6, "relax_integrality": False,
           "min_up_down": True, "ramping": True, "t0_state": True,
           "startup_shutdown_ramps": True}


def build(model, S=None, uc_kw=None):
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import farmer, hydro, uc
    if model == "farmer":
        return build_batch(farmer.scenario_creator, farmer.make_tree(S))
    if model == "hydro":
        return build_batch(hydro.scenario_creator, hydro.make_tree())
    if isinstance(S, tuple):
        # ("perm", order): the UC scenarios in another order
        from mpisppy_tpu_torch.ir.tree import two_stage_tree
        tree = two_stage_tree([f"scen{i}" for i in S[1]],
                              nonant_names=["u", "st"])
    else:
        tree = uc.make_tree(S)
    return build_batch(uc.scenario_creator, tree,
                       creator_kwargs=dict(uc_kw or _UC_KW),
                       vector_patch=uc.scenario_vector_patch)


def _whole(ph, t):
    return ph.gather_rows(t).cpu().numpy()


class _Trace:
    """Extension: the host trace of a run (conv per iteration, the chunk
    retry blacklist and the gate syncs booked so far)."""

    def __init__(self):
        self.rows = []

    def miditer(self, ph):
        self.rows.append({
            "iter": ph._iter, "conv": ph.conv,
            "no_retry": sorted(ph._chunk_no_retry.get(True, set())),
            "gate_syncs": (ph._phase_times.get(True) or {}).get(
                "gate_syncs", 0)})

    def __getattr__(self, name):
        return lambda ph: None


def ph_run(mesh, spec):
    """PH over ``spec``: {"model", "S", "uc_kw", "opts", "main": True
    for PH.ph_main (else ``iters`` solve_loop passes, iter 0 first,
    whose x̄, W and conv are returned as ``iter0``)}."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.ph import PH, PHBase
    batch = build(spec["model"], spec.get("S"), spec.get("uc_kw"))
    trace = _Trace()
    first = None
    obs.configure()
    try:
        if spec.get("main", True):
            ph = PH(batch, dict(spec["opts"]), device="cpu", mesh=mesh,
                    extensions=trace)
            conv, eobj, tbound = ph.ph_main()
        else:
            ph = PHBase(batch, dict(spec["opts"]), device="cpu",
                        mesh=mesh)
            poison = spec.get("poison")     # (rank, iteration)
            me = 0 if mesh is None else mesh.rank
            for it in range(spec.get("iters", 2)):
                ph._iter = it
                if poison is not None and (me, it) == tuple(poison):
                    # NaN warm iterates in this rank's rows of chunk 0
                    sts = ph._chunk_states[True]
                    sts[0] = sts[0]._replace(x=sts[0].x * float("nan"))
                ph.solve_loop(w_on=it > 0, prox_on=it > 0)
                ph.W = ph.W_new
                trace.miditer(ph)
                if it == 0:
                    first = {"xbar": _whole(ph, ph.xbar),
                             "W": _whole(ph, ph.W), "conv": float(ph.conv)}
            conv, eobj = ph.conv, ph.Eobjective_value()
            tbound = None
        gate_syncs = obs.counters_snapshot().get("ph.gate_syncs", 0)
    finally:
        obs.shutdown()
    rs = ph.residual_summary(True)
    return {"xbar": _whole(ph, ph.xbar), "W": _whole(ph, ph.W),
            "prob": _whole(ph, ph.prob), "conv": conv, "eobj": eobj,
            "trivial_bound": tbound, "S": ph.global_batch.S,
            "S_orig": ph._S_orig, "shard": ph.batch.S,
            "pt": ph.phase_timing(True), "trace": trace.rows,
            "gate_syncs": gate_syncs, "residual_summary": rs,
            "iter0": first}


def combine_check(mesh, spec):
    """The engine's collective x̄/W/conv reduction on random (seeded)
    nonant blocks: every rank's rows of the same global inputs."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch.core.ph import PHBase
    batch = build(spec["model"], spec.get("S"), spec.get("uc_kw"))
    ph = PHBase(batch, {"defaultPHrho": 3.0}, device="cpu", mesh=mesh)
    S, K = ph.global_batch.S, ph.batch.K
    rng = np.random.default_rng(spec.get("seed", 0))
    xn, W = rng.normal(size=(S, K)), rng.normal(size=(S, K))
    rho = rng.uniform(0.5, 2.0, size=(S, K))
    lo = ph._row0
    rows = slice(lo, lo + ph.batch.S)
    t = lambda a: torch.as_tensor(a[rows])  # noqa: E731
    from mpisppy_tpu_torch.core.ph import _ph_combine
    xbar, xsqbar, W_new, conv = _ph_combine(
        t(xn), ph.prob, ph.xbar_weights, tuple(ph.memberships), t(W),
        t(rho), None, slot_slices=ph.slot_bounds, shard_ops=ph._shard_ops)
    out = {"xn": xn, "W": W, "rho": rho, "prob": _whole(ph, ph.prob),
           "xbar": _whole(ph, xbar), "xsqbar": _whole(ph, xsqbar),
           "W_new": _whole(ph, W_new), "conv": float(conv)}
    if ph._shard_ops is not None:
        out["bytes"] = ph._shard_ops.combine_collective_bytes(8)
    return out


def aph_run(mesh, spec):
    """APH over ``spec`` (as ph_run's, APH options): the per-iteration
    dispatch records, the gate syncs, the final W, x̄, conv."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core.aph import APH
    batch = build(spec["model"], spec.get("S"), spec.get("uc_kw"))
    recs = []

    class Rec:
        def enditer(self, ph):
            recs.append({"status": dict(ph._aph_status),
                         "dispatched": _whole(ph, torch.as_tensor(
                             ph._dispatched.astype(np.uint8))).tolist()})

        def __getattr__(self, name):
            return lambda ph: None

    obs.configure()
    try:
        aph = APH(batch, dict(spec["opts"]), device="cpu", mesh=mesh,
                  extensions=Rec())
        conv, eobj, tbound = aph.APH_main()
        gate = obs.counters_snapshot().get("aph.gate_syncs", 0)
    finally:
        obs.shutdown()
    return {"xbar": _whole(aph, aph.xbar), "W": _whole(aph, aph.W),
            "conv": conv, "eobj": eobj, "trivial_bound": tbound,
            "recs": recs, "gate_syncs": gate,
            "iters": aph._iter, "S_orig": aph._S_orig,
            "capable": aph._dispatch_capable()}


def shrink_run(mesh, spec):
    """PH with the device fixer and compaction on: the shrink status,
    the plan checksum and the final x̄, W, conv."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch.core.ph import PH
    batch = build(spec["model"], spec.get("S"), spec.get("uc_kw"))
    ph = PH(batch, dict(spec["opts"]), device="cpu", mesh=mesh)
    conv, eobj, tbound = ph.ph_main()
    return {"xbar": _whole(ph, ph.xbar), "W": _whole(ph, ph.W),
            "conv": conv, "eobj": eobj, "trivial_bound": tbound,
            "status": dict(ph._shrink_status),
            "checksum": getattr(ph, "_plan_checksum", None),
            "fixed": int(ph._fixed_mask.all(dim=0).sum())}


def wheel_run(mesh, cfg_kw):
    """The CLI's wheel from a RunConfig (rank 0's result dict; the
    other ranks return None)."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch.utils.config import (AlgoConfig, RunConfig,
                                                SpokeConfig)
    from mpisppy_tpu_torch.utils.sputils import wheel_on_mesh
    kw = dict(cfg_kw)
    kw["algo"] = AlgoConfig(**kw.pop("algo"))
    kw["spokes"] = [SpokeConfig(kind=k) for k in kw.pop("spokes")]
    return wheel_on_mesh(mesh, RunConfig(**kw).validate())


def raise_on(mesh, rank):
    """Raises on ``rank`` after a first collective; the other ranks wait
    in a second one that never completes."""
    torch.set_num_threads(1)
    mesh.all_sum(torch.ones(1))
    if mesh.rank == rank:
        raise ValueError(f"planted failure on rank {rank}")
    mesh.all_sum(torch.ones(1))
    return mesh.rank


def slot0_fix_list(b):
    """Only nonant slot 0 ever fixes (tests/test_shrink.py's list): a
    PARTIAL fixed set, so compaction keeps free slots."""
    from mpisppy_tpu_torch.extensions.fixer import uniform_fix_list
    spec = uniform_fix_list(b, tol=5e-1, nb=3, lb=3, ub=3,
                            integer_only=False)
    for k in ("nb", "lb", "ub"):
        a = np.minimum(spec[k], 2 ** 30).copy()
        a[1:] = 2 ** 30
        spec[k] = a
    return spec


def hospital_run(mesh, spec):
    """The scenario hospital on a chunked run. Iteration 1's chunk solve
    returns global scenario ``spec["plant"]`` flagged unconverged with a
    zero solution row, and every chunk's retry is blacklisted, so the
    gate sends that scenario to the hospital. Then the hospital is
    called once more on the same planted row, with the system in its
    shared (m, n) form and in the per-scenario (S, m, n) form: the
    rescued rows must agree. Returns the hospital notes, x̄, W and, on
    the rank that owns the planted row, the rescued rows."""
    torch.set_num_threads(1)
    from mpisppy_tpu_torch import obs
    from mpisppy_tpu_torch.core import ph as ph_mod
    batch = build(spec["model"], spec.get("S"), spec.get("uc_kw"))
    ph = ph_mod.PHBase(batch, dict(spec["opts"]), device="cpu", mesh=mesh)
    g = spec["plant"]
    lc = ph._local_chunk(int(spec["opts"]["subproblem_chunk"]))
    loc = g - ph._row0
    own = 0 <= loc < ph.batch.S
    ci_p, r_p = loc // lc, torch.tensor([loc % lc])
    real = ph_mod._solver_call
    calls = {"n": None}

    def planted(*a, **kw):
        st, x, yA, yB = real(*a, **kw)
        c = calls["n"]
        if c is not None:
            calls["n"] = c + 1
            if own and c == ci_p:
                st = st._replace(pri_rel=st.pri_rel.index_fill(0, r_p, 1.0))
                x = x.index_fill(0, r_p, 0.0)
        return st, x, yA, yB

    n_chunks = ph.batch.S // lc if mesh is not None and mesh.size > 1 \
        else len(ph._chunk_index(lc))
    ph_mod._solver_call = planted
    obs.configure()
    try:
        for it in range(2):
            ph._iter = it
            if it == 1:
                ph._chunk_no_retry[True] = set(range(n_chunks))
                calls["n"] = 0
            ph.solve_loop(w_on=it > 0, prox_on=it > 0)
            calls["n"] = None
            ph.W = ph.W_new
        notes = [e[1] for e in obs.events("ph.hospital")]
    finally:
        ph_mod._solver_call = real
        obs.shutdown()
    out = {"notes": notes, "xbar": _whole(ph, ph.xbar),
           "W": _whole(ph, ph.W), "S": ph.global_batch.S}
    # the hospital called directly on the planted row, in both forms
    factors, data = ph._get_factors(True)
    slices = ph._chunk_index(lc)
    S_loc, n, m = ph.batch.S, ph.batch.n, ph.batch.m
    batched = data._replace(A=data.A.expand(S_loc, m, n),
                            P_diag=data.P_diag.expand(S_loc, n))
    kw = dict(prox_on=True, precision=ph.sub_precision,
              sub_max_iter=ph.sub_max_iter, sub_eps=ph.sub_eps,
              sub_eps_hot=ph.sub_eps_hot,
              sub_eps_dua_hot=ph.sub_eps_dua_hot,
              tail_iter=ph.sub_tail_iter, stall_rel=ph.sub_stall_rel,
              segment=ph.sub_segment, polish_hot=ph.sub_polish_hot,
              polish_chunk=0)
    for form, d in (("shared", data), ("batched", batched)):
        recs = []
        for ci, _ in enumerate(slices):
            st = ph._chunk_states[True][ci]
            if own and ci == ci_p:
                st = st._replace(pri_rel=st.pri_rel.index_fill(0, r_p, 1.0))
            recs.append([st, torch.zeros(lc, n, dtype=torch.float64),
                         torch.zeros(lc, m, dtype=torch.float64),
                         torch.zeros(lc, n, dtype=torch.float64), None,
                         None])
        pri = torch.stack([rec[0].pri_rel for rec in recs]).unsqueeze(0)
        if ph.shard_mesh is not None:
            pri = ph.mesh.gather_rows(pri, mesh.size)
        pri_glob = pri.numpy().copy()
        ph._hospital_no_retry.clear()
        syncs = ph._hospitalize(True, slices, recs, d, thr=1e-2, w_on=True,
                                prox_on=True, kw=kw, pri_glob=pri_glob)
        out[form] = {"syncs": syncs, "pri_glob": pri_glob,
                     "rows": [t[r_p.item()].numpy() for t in
                              (recs[ci_p][1], recs[ci_p][2],
                               recs[ci_p][3])] if own else None}
    return out


def stream_run(mesh, spec):
    """PH on the farmer synth family (S = spec["S"], seed 7) from
    ``spec["source"]`` ("resident", "streamed" or "synthesized"): the
    run's (conv, Eobjective, trivial bound), x̄ and W."""
    from mpisppy_tpu_torch.core.ph import PH
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.stream import synth_batch
    torch.set_num_threads(1)
    source = spec["source"]
    batch, synth = synth_batch(
        farmer.scenario_creator, farmer.make_tree(spec["S"]),
        farmer.scenario_synth_spec, seed=7,
        materialize_values=source != "synthesized")
    opts = dict(spec["opts"])
    if source != "resident":
        opts["scenario_source"] = source
    if source == "synthesized":
        opts["synth_spec"] = synth
    ph = PH(batch, opts, mesh=mesh) if mesh is not None \
        else PH(batch, opts, device="cpu")
    out = ph.ph_main()
    ph.close_stream()
    return {"result": out, "xbar": _whole(ph, ph.xbar),
            "W": _whole(ph, ph.W)}
