"""Where a 2-rank mesh's PH iterates part from the unsharded run's.

chip_smoke.py's phase 19 (cell uc-ref-S10-mesh2) runs the main path's
batch and options over 2 ranks of 5 rows each and holds x̄, W and conv
against the unsharded 10-row run. Every operation of a PH iteration
computes each scenario row on its own, so the two runs can differ only
where an operation's arithmetic for a row depends on how many rows it
is given. This script finds those operations: it records the inputs of
one unsharded run's solves (iteration 0, prox off, polished; iteration
1, prox on, not polished) and replays each operation on the same inputs,
once on all rows and once on each half, in one process:

- ``block``: the hand-written ADMM block (fused_admm_block) over the
  solve's whole fixed-rho budget;
- ``finisher``: qp_solve(max_iter=0) on the block's output (the
  unscaling, the residual products and, in iteration 0, the polish in
  groups of ``subproblem_polish_chunk`` rows; a 5-row half polishes its
  last row alone), and the same without the polish;
- ``polish_groups``: the whole's finisher with polish groups of 1 row
  against groups of 2 (the half's lone row against its pair);
- ``combine``: x̄ and W from the solve's x as one process forms them
  and as the mesh does (each half's node tables, then their sum:
  parallel/mesh.node_means);
- ``iteration1_from_mesh_combine``: iteration 1's solve and combine run
  twice on the whole batch, from iteration 0's x̄ and W as one process
  forms them and as the mesh does, everything else equal: how far the
  combine's difference travels through one prox-on solve.

For each it prints the largest difference of the halves' rows from the
whole's, relative to max(1, max |whole|), and the rows where any output
differs. Run it where the card is:

    python3 trace_mesh_gap.py             # the main path's UC, S = 10
    python3 trace_mesh_gap.py --cpu       # UC 3 x 6, S = 10, on the CPU

Each record is one JSON line on standard output.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _rows_data(d, sl):
    return d._replace(l=d.l[sl], u=d.u[sl], lb=d.lb[sl], ub=d.ub[sl])


def _rows_state(st, sl):
    per_row = ("x", "yA", "yB", "zA", "zB", "pri_res", "dua_res",
               "pri_rel", "dua_rel")
    return st._replace(**{k: getattr(st, k)[sl] for k in per_row})


class _Tables:
    """A stand-in for a 2-rank mesh in parallel/mesh.node_means: records
    each half's packed node tables, or returns the sum of both."""
    size = 2

    def __init__(self, store, total=None):
        self.store, self.total = store, total

    def all_sum(self, t):
        if self.total is not None:
            return self.total
        self.store.append(t)
        return t


def _diff(whole, halves, names):
    """Largest relative difference per output and the rows that differ."""
    import torch
    out, rows = {}, set()
    for name, w, parts in zip(names, whole, zip(*halves)):
        h = torch.cat(parts)
        d = (h - w).abs()
        if d.ndim > 1:
            d = d.amax(dim=1)
        out[name] = float(d.max()) / max(1.0, float(w.abs().max()))
        rows |= set(int(i) for i in torch.nonzero(d > 0).flatten())
    return {"rel_diff": out, "rows_differing": sorted(rows)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import chip_smoke as cs
    from mpisppy_tpu_torch.core.ph import PHBase, _ph_combine
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import kernels
    from mpisppy_tpu_torch.ops.kernels import admm_block
    from mpisppy_tpu_torch.ops.qp_solver import qp_solve
    from mpisppy_tpu_torch.parallel.mesh import node_means
    from mpisppy_tpu_torch.utils.runtime import pin_precision
    pin_precision()
    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        print("trace_mesh_gap: no CUDA device (--cpu runs the small case "
              "on the CPU)", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if cpu else "cuda")
    inst = dict(num_gens=3, num_hours=6) if cpu else cs.SLICE_INSTANCE
    opts = dict(cs.PH_OPTS)
    if cpu:
        opts["subproblem_max_iter"] = 200
    def emit(rec):
        print(json.dumps(rec), flush=True)

    if not cpu:
        emit({"card": cs.card_line()})
    t0 = time.perf_counter()
    batch = build_batch(uc.scenario_creator, uc.make_tree(10),
                        creator_kwargs=inst,
                        vector_patch=uc.scenario_vector_patch)
    ph = PHBase(batch, opts, device=dev)
    S = ph.batch.S
    halves = (slice(0, S // 2), slice(S // 2, S))
    calls = []
    real = kernels.kernel_solve

    def record(plan, factors, data, q, state, **kw):
        calls.append((plan, factors, data, q, state, kw))
        return real(plan, factors, data, q, state, **kw)

    kernels.kernel_solve = record
    W_in = []           # the hub's W entering each iteration
    try:
        for it in range(2):
            W_in.append(ph.W.clone())
            ph.solve_loop(w_on=it > 0, prox_on=it > 0)
            ph.W = ph.W_new
    finally:
        kernels.kernel_solve = real
    emit({"setup_s": time.perf_counter() - t0, "S": S, "n": ph.batch.n,
          "m": ph.batch.m, "solves": len(calls)})

    def combine_whole(x, W):
        xn = x[:, ph.nonant_idx]
        xbar, _, W_new, _ = _ph_combine(
            xn, ph.prob, ph.xbar_weights, tuple(ph.memberships), W, ph.rho,
            None, slot_slices=ph.slot_bounds)
        return xbar, W_new

    def combine_halves(x, W):
        xn = x[:, ph.nonant_idx]
        flats = []
        for sl in halves:
            node_means([B[sl] for B in ph.memberships], ph.slot_bounds,
                       ph.prob[sl], xn[sl], _Tables(flats))
        total = _Tables(None, flats[0] + flats[1])
        xbar = torch.cat([node_means(
            [B[sl] for B in ph.memberships], ph.slot_bounds, ph.prob[sl],
            xn[sl], total)[0] for sl in halves])
        return xbar, W + ph.rho * (xn - xbar)

    it_names = ("x", "yA", "yB", "zA", "zB", "pri", "dua")
    for it, (plan, f, d, q, st, kw) in enumerate(calls):
        t0 = time.perf_counter()
        n_steps = kw["max_iter"]

        def block(sl):
            return admm_block.fused_admm_block(
                f, _rows_data(d, sl), q[sl], _rows_state(st, sl),
                n_steps=n_steps, sigma=plan.sigma_host)

        blk = block(slice(0, S))
        rec = {"iteration": it, "polish": kw["polish"],
               "polish_chunk": kw["polish_chunk"],
               "block": _diff(blk, [block(sl) for sl in halves],
                              it_names)}
        st_b = st._replace(**dict(zip(("x", "yA", "yB", "zA", "zB"),
                                      blk[:5])))

        def finish_kw(**over):
            # kernel_solve's own finisher options
            return dict(dict(check_every=kw.get("check_every", 25),
                             eps_abs=kw["e_pri"], eps_rel=kw["e_pri"],
                             polish=kw["polish"],
                             polish_iters=kw.get("polish_iters", 12),
                             polish_chunk=kw["polish_chunk"],
                             eps_abs_dua=kw["e_dua"],
                             eps_rel_dua=kw["e_dua"],
                             stall_rel=kw["stall_rel"],
                             adaptive_rho=kw.get("adaptive_rho", True)),
                        **over)

        def finish(sl, **over):
            new, x, yA, yB = qp_solve(f, _rows_data(d, sl), q[sl],
                                      _rows_state(st_b, sl), max_iter=0,
                                      **finish_kw(**over))
            return x, yA, yB, new.pri_rel, new.dua_rel

        fin_names = ("x", "yA", "yB", "pri_rel", "dua_rel")
        whole = finish(slice(0, S))
        rec["finisher"] = _diff(whole, [finish(sl) for sl in halves],
                                fin_names)
        if kw["polish"]:
            rec["finisher_no_polish"] = _diff(
                finish(slice(0, S), polish=False),
                [finish(sl, polish=False) for sl in halves], fin_names)
            rec["polish_groups_1_vs_2"] = _diff(
                whole, [finish(slice(0, S), polish_chunk=1)], fin_names)
        # the combine on the whole's solution: one process's membership
        # products against the mesh's (each half's node tables, summed)
        xbar_m, W_m = combine_whole(whole[0], W_in[it])
        xbar_s, W_s = combine_halves(whole[0], W_in[it])
        rec["combine"] = _diff((xbar_m, W_m), [(xbar_s, W_s)],
                               ("xbar", "W"))
        if it == 1:
            # iteration 1 once more from the mesh's iteration-0 combine:
            # the whole solve (block, finisher) and combine from the
            # whole's (x̄, W) and from the halves', everything else equal
            outs = []
            for xb, Wb in ((xb0_m, W0_m), (xb0_s, W0_s)):
                q1 = ph.c.index_add(1, ph.nonant_idx, Wb - ph.rho * xb)
                b = admm_block.fused_admm_block(f, d, q1, st,
                                                n_steps=n_steps,
                                                sigma=plan.sigma_host)
                st_1 = st._replace(**dict(zip(("x", "yA", "yB", "zA",
                                               "zB"), b[:5])))
                _, x1, _, _ = qp_solve(f, d, q1, st_1, max_iter=0,
                                       **finish_kw())
                outs.append((x1,) + combine_whole(x1, Wb))
            rec["iteration1_from_mesh_combine"] = _diff(
                outs[0], [outs[1]], ("x", "xbar", "W"))
            rec["iteration1_from_mesh_combine"]["q_is_recorded"] = bool(
                torch.equal(ph.c.index_add(1, ph.nonant_idx,
                                           W0_m - ph.rho * xb0_m), q))
        else:
            xb0_m, W0_m, xb0_s, W0_s = xbar_m, W_m, xbar_s, W_s
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
