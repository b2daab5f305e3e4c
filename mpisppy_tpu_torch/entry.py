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
