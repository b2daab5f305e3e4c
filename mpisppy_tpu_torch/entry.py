"""The port's twin of the JAX package's ``__graft_entry__.entry()``: one
shape-stable PH step on the flagship stochastic unit-commitment batch.

``entry(device=None)`` returns ``(fn, example_args)``. ``fn(*args)`` is
one PH iteration composed from its three stages, as the JAX entry
composes them: ``core/ph._ph_assemble`` (the W and prox terms, nonant
pinning), ``ops/qp_solver.qp_solve`` (200 ADMM iterations at eps 1e-4,
the polish on) and ``core/ph._ph_reduce`` (x̄, W, conv, the objectives
and the certified dual bound). Every large tensor (factors, data, costs,
hub state) is an argument. The batch is uc(S=8, G=4, T=6) with
``defaultPHrho`` 100, on the CUDA device unless ``device`` says
otherwise.

    fn, args = entry(device="cpu")
    (qp_state, x, yA, yB, xn, xbar, xsqbar, W, conv, base_obj,
     solved_obj, dual_obj) = fn(*args)

``dryrun_multichip(n, device=None)`` is the twin of
``__graft_entry__.dryrun_multichip``: the scenario-chunked df32 PH step
(iter 0 and one prox-on step) on a UC with 6 generators x 6 hours and
every constraint family on, S = 2n, chunk 1 per rank, plus the batched
integer dive, sharded over n ranks started by parallel/launch (gloo on
the CPU). It returns rank 0's summary dict.
"""

from __future__ import annotations

ENTRY_SCENARIOS = 8
ENTRY_GENS = 4
ENTRY_HOURS = 6
ENTRY_OPTIONS = {"defaultPHrho": 100.0, "subproblem_max_iter": 200,
                 "subproblem_eps": 1e-4}


def _build(device):
    from .core.ph import PHBase
    from .ir.batch import build_batch
    from .models import uc

    batch = build_batch(uc.scenario_creator, uc.make_tree(ENTRY_SCENARIOS),
                        creator_kwargs={"num_gens": ENTRY_GENS,
                                        "num_hours": ENTRY_HOURS})
    return PHBase(batch, dict(ENTRY_OPTIONS), device=device)


def entry(device=None):
    """Return ``(fn, example_args)``: one PH iteration (assemble, one
    solve, reduce) on the flagship model, every large tensor an
    argument."""
    from .core.ph import _ph_assemble, _ph_reduce
    from .ops.qp_solver import qp_solve

    ph = _build(device)
    qp_state = ph._ensure_state(True)
    factors, data = ph._get_factors(True)
    args = (qp_state, factors, data, ph.c, ph.c0, ph.P_diag, ph.prob,
            ph.xbar_weights, tuple(ph.memberships), ph.nonant_idx,
            ph.W, ph.xbar, ph.rho, ph._fixed_mask, ph._fixed_vals)
    slot_slices = ph.slot_bounds
    sub_max_iter, sub_eps = ph.sub_max_iter, ph.sub_eps

    def fn(qp_state, factors, data, c, c0, P0, prob, xbar_w, memberships,
           idx, W, xbar, rho, fixed_mask, fixed_vals):
        q, bl, bu = _ph_assemble(data, c, W, xbar, rho, idx, fixed_mask,
                                 fixed_vals, None, w_on=True,
                                 prox_on=True)
        d = data._replace(lb=bl, ub=bu)
        qp_state, x, yA, yB = qp_solve(factors, d, q, qp_state,
                                       max_iter=sub_max_iter,
                                       eps_abs=sub_eps, eps_rel=sub_eps)
        (xn, xbar_new, xsqbar_new, W_new, conv, base_obj, solved_obj,
         dual_obj) = _ph_reduce(x, yA, yB, d, q, c, c0, P0, prob, xbar_w,
                                memberships, idx, W, rho, None,
                                w_on=True, slot_slices=slot_slices)
        return (qp_state, x, yA, yB, xn, xbar_new, xsqbar_new, W_new,
                conv, base_obj, solved_obj, dual_obj)

    return fn, args


DRYRUN_OPTIONS = {"defaultPHrho": 100.0, "subproblem_max_iter": 600,
                  "subproblem_eps": 1e-5, "subproblem_precision": "df32",
                  "subproblem_tail_iter": 400, "subproblem_chunk": 1,
                  "subproblem_hospital": False, "iter0_feas_tol": 2e-2}


def _dryrun_rank(mesh):
    import numpy as np
    import torch

    from .core.ph import PHBase
    from .ir.batch import build_batch
    from .models import uc
    from .ops.qp_solver import SplitMatrix

    n_dev = mesh.size
    S = 2 * n_dev
    batch = build_batch(
        uc.scenario_creator, uc.make_tree(S),
        creator_kwargs={"num_gens": 6, "num_hours": 6,
                        "relax_integrality": False, "min_up_down": True,
                        "ramping": True, "t0_state": True,
                        "startup_shutdown_ramps": True},
        vector_patch=uc.scenario_vector_patch)
    ph = PHBase(batch, dict(DRYRUN_OPTIONS), mesh=mesh)
    if not (isinstance(ph.qp_data.A, SplitMatrix)
            and ph.qp_data.A.struct is not None):
        raise RuntimeError("the dryrun must run the packed df32 "
                           "representation")
    ph.solve_loop(w_on=False, prox_on=False)       # iter 0, chunked
    ph.W = ph.W_new
    ph.solve_loop(w_on=True, prox_on=True)         # one hot step
    xbar = ph.gather_rows(ph.xbar)
    if not bool(torch.isfinite(xbar).all()):
        raise RuntimeError("the sharded step left a non-finite x̄")
    pt = ph.phase_timing(True)
    want = "sharded" if n_dev > 1 else "host"
    if pt["mode"] != want or pt["devices"] != n_dev:
        raise RuntimeError(f"the {want} chunked path must engage: {pt}")
    # the incumbent dive (commitments pinned, startups derived)
    idx = np.asarray(batch.nonant_idx)
    col_in = np.zeros(batch.n, bool)
    col_in[batch.template.var_slices["u"]] = True
    cands, feas = ph.dive_nonant_candidates(xbar.cpu().numpy(),
                                            dive_slots=col_in[idx])
    return {"mode": pt["mode"], "devices": pt["devices"], "S": S,
            "shard": ph.batch.S, "conv": ph.conv,
            "cands_shape": list(cands.shape),
            "dive_feasible": int(np.sum(feas)),
            "backend": mesh.backend}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded production step on ``n_devices`` ranks (see the
    module docstring); ``device="cpu"`` runs every rank on the CPU."""
    from .parallel.launch import launch
    return launch(_dryrun_rank, int(n_devices), device=device)[0]
