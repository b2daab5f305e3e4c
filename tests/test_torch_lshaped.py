"""The port's L-shaped method (mpisppy_tpu_torch core/lshaped.py) and
its certified cuts (ops/qp_solver.benders_cut) against the JAX
package's on the same batches: the cut builder on the same inputs, one
round started from carried state (utils/carry), the cases of
tests/test_lshaped.py, per-scenario rho on a shared-structure batch,
and the L-shaped wheel."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core.lshaped import LShapedMethod as JaxLShaped
from mpisppy_tpu.core.ph import PH as JaxPH
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops import qp_solver as jax_qp
from mpisppy_tpu_torch.core.lshaped import LShapedMethod
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.cylinders.hub import LShapedHub
from mpisppy_tpu_torch.cylinders.xhat_bounders import XhatLShapedInnerBound
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, netdes, uc
from mpisppy_tpu_torch.ops import qp_solver
from mpisppy_tpu_torch.utils.carry import from_numpy_state
from mpisppy_tpu_torch.utils.sputils import spin_the_wheel
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EF_OBJ = -108390.0
_UC_KW = {"num_gens": 3, "num_hours": 6}
# the slice's options at this size: the hand-written block's backend
# (its plain version on the CPU), the whole budget at fixed rho
_UC_OPTS = {"defaultPHrho": 100.0, "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_max_iter": 400, "subproblem_polish_hot": False,
            "subproblem_polish_chunk": 2, "max_iter": 6}


def _farmer(num_scens=3):
    return build_batch(farmer.scenario_creator, farmer.make_tree(num_scens))


def _jax_farmer(num_scens=3):
    return jax_build_batch(jax_farmer.scenario_creator,
                           jax_farmer.make_tree(num_scens))


def _uc_pair(S=3):
    return (jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                            creator_kwargs=_UC_KW,
                            vector_patch=jax_uc.scenario_vector_patch),
            build_batch(uc.scenario_creator, uc.make_tree(S),
                        creator_kwargs=_UC_KW,
                        vector_patch=uc.scenario_vector_patch))


# ---- benders_cut ----

def _cut_inputs(shared, seed=0):
    """(data, q, c0, yA, yB, mask, b0) as numpy: columns 0-1 pinned at
    b0, column 5 free (a nonzero reduced cost there gives a -inf cut
    for the scenarios whose r_5 survives), infinite row and box sides
    with wrong-sign duals pushing on them."""
    rng = np.random.RandomState(seed)
    S, m, n = 3, 5, 6
    A = rng.normal(size=(m, n) if shared else (S, m, n))
    P = np.abs(rng.normal(size=n)) * (rng.uniform(size=n) > 0.4)
    P = P if shared else np.abs(rng.normal(size=(S, n)))
    P[..., 3:] = 0.0     # linear where a box side is infinite
    l = rng.normal(size=(S, m)) - 1.0
    u = l + rng.uniform(0.5, 2.0, size=(S, m))
    l[:, 0] = -np.inf
    u[:, 1] = np.inf
    lb = np.full((S, n), -1.0)
    ub = np.full((S, n), 2.0)
    lb[:, 3] = -np.inf
    ub[:, 4] = np.inf
    lb[:, 5], ub[:, 5] = -np.inf, np.inf
    b0 = np.zeros((S, n))
    b0[:, :2] = rng.uniform(-1, 1, size=(S, 2))
    lb[:, :2] = ub[:, :2] = b0[:, :2]
    mask = np.zeros(n, bool)
    mask[:2] = True
    q = rng.normal(size=(S, n))
    c0 = rng.normal(size=S)
    yA = rng.normal(size=(S, m))
    yA[:, 0] = -np.abs(yA[:, 0])     # wrong sign at l = -inf
    yA[:, 1] = np.abs(yA[:, 1])      # wrong sign at u = +inf
    yB = rng.normal(size=(S, n))
    yB[:, 3] = -np.abs(yB[:, 3])
    yB[:, 4] = np.abs(yB[:, 4])
    # scenario 0: zero reduced cost and bound dual on the columns with
    # an infinite side (a finite cut); the others keep a nonzero
    # reduced cost on the free column (a -inf cut)
    yB[:, 5] = 0.0
    yB[0, 3:] = 0.0
    r = q + np.einsum("sm,mn->sn" if shared else "sm,smn->sn",
                      np.where((np.isneginf(l) & (yA < 0))
                               | (np.isposinf(u) & (yA > 0)), 0.0, yA), A)
    q[0, 3:] -= r[0, 3:]
    return (P, A, l, u, lb, ub), q, c0, yA, yB, mask, b0


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_benders_cut_matches_jax(shared, seed):
    """The same inputs through both packages' cut builders: const and g
    equal to 1e-12 relative, -inf where a free column's reduced cost
    survives; a finite cut minorizes the value function at a probe."""
    data, q, c0, yA, yB, mask, b0 = _cut_inputs(shared, seed)
    jd = jax_qp.QPData(*(jnp.asarray(a) for a in data))
    j_const, j_g = jax_qp.benders_cut(jd, jnp.asarray(q), jnp.asarray(c0),
                                      jnp.asarray(yA), jnp.asarray(yB),
                                      jnp.asarray(mask), jnp.asarray(b0))
    pd = qp_solver.QPData(*(torch.as_tensor(a) for a in data))
    const, g = qp_solver.benders_cut(
        pd, torch.as_tensor(q), torch.as_tensor(c0), torch.as_tensor(yA),
        torch.as_tensor(yB), torch.as_tensor(mask), torch.as_tensor(b0))
    np.testing.assert_allclose(const.numpy(), np.asarray(j_const),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-12,
                               atol=0)
    c = const.numpy()
    assert np.isfinite(c[0]) and np.isneginf(c[1:]).all()
    assert (g.numpy()[:, ~mask] == 0).all()
    # validity at a probe b: the cut lies below V(b), the HiGHS value
    # of scenario 0's LP or QP with the pinned columns at b
    from scipy.optimize import minimize
    P, A, l, u, lb, ub = data
    A0 = A if shared else A[0]
    P0 = P if shared else P[0]
    b = np.array([0.3, -0.7])
    lo, hi = lb[0].copy(), ub[0].copy()
    lo[:2] = hi[:2] = b
    cons = []
    for i in range(A0.shape[0]):
        if np.isfinite(u[0, i]):
            cons.append({"type": "ineq",
                         "fun": lambda x, i=i: u[0, i] - A0[i] @ x})
        if np.isfinite(l[0, i]):
            cons.append({"type": "ineq",
                         "fun": lambda x, i=i: A0[i] @ x - l[0, i]})
    res = minimize(lambda x: 0.5 * P0 @ (x * x) + q[0] @ x + c0[0],
                   np.clip(np.zeros(6), lo, hi), method="SLSQP",
                   bounds=[(a if np.isfinite(a) else None,
                            z if np.isfinite(z) else None)
                           for a, z in zip(lo, hi)],
                   constraints=cons, options={"ftol": 1e-12,
                                              "maxiter": 500})
    if res.success:
        assert c[0] + g.numpy()[0, :2] @ b <= res.fun + 1e-6 * max(
            1.0, abs(res.fun))


# ---- one round from carried state ----

def _carry_arrays(j, pinned=True):
    """The JAX engine's prox-off and pinned solver states and its master
    buffer, as utils/carry takes them (no pinned state before the
    engine's first cut solve)."""
    def state(st):
        d = {k: np.asarray(getattr(st, k))
             for k in ("x", "yA", "yB", "zA", "zB", "rho_scale")}
        d["F"] = np.asarray(st.L)
        return d
    return (state(j._qp_states[False]),
            state(j._qp_states[("fixed", False)]) if pinned else None,
            {"mA": j._mA, "ml": j._ml, "mu": j._mu,
             "slots_filled": j._slots_filled, "lb_master": j._lb_master})


def _assert_round_matches(cj, cp, xr, j, p):
    """One round's cuts at the rounded point ``xr`` and the master rows
    against the JAX engine's. Where the JAX cut is finite, its kept dual
    candidate certified it without the witness, so the port's cut solve
    (ops/qp_solver.cut_dual_selection) keeps the same candidate, up to
    the polish's roundoff (ROADMAP.md C.1: a polished certified value
    reproduces to ~1e-6 relative in either package): the cut's value at
    the point agrees to 1e-6 relative and its slope to 1e-5 of its
    largest entry (measured on UC 3x6: 3.8e-8 and 1.1e-6). Where the
    JAX cut is -inf, the port keeps the best witness-free candidate
    instead, a -inf or a finite (valid) cut; that row is inactive in
    the JAX master."""
    fin = np.isfinite(cj[0])
    assert np.all(np.isfinite(cp[0][fin]))
    np.testing.assert_allclose((cp[0] + cp[1] @ xr)[fin],
                               (cj[0] + cj[1] @ xr)[fin], rtol=1e-6)
    np.testing.assert_allclose(cp[1][fin], cj[1][fin], rtol=0,
                               atol=1e-5 * np.abs(cj[1]).max())
    assert (cj[2] is None) == (cp[2] is None)
    if cj[2] is not None:
        assert cp[2] == pytest.approx(cj[2], rel=1e-10)
    j.add_cuts(cj[0], cj[1])
    p.add_cuts(cp[0], cp[1])
    rows = np.isfinite(j._ml)
    assert np.all(np.isfinite(p._ml[rows]))
    np.testing.assert_allclose(p._mA[rows], j._mA[rows], rtol=0,
                               atol=1e-5 * np.abs(j._mA[rows]).max())
    np.testing.assert_array_equal(p._mu, j._mu)
    np.testing.assert_array_equal(p._slots_filled, j._slots_filled)
    np.testing.assert_array_equal(p._lb_master, j._lb_master)


def test_round_from_carried_jax_state_matches():
    """Both packages start an L-shaped round from the JAX engine's state
    on UC 3x6 with the slice's block options. After its eta bounds (the
    prox-off state and the empty cut buffer), one round's cuts and
    master rows agree (_assert_round_matches; the JAX round's cut of
    scenario 1 is finite there). After two more rounds (the prox-off
    state, the pinned state, the cut buffer): the master solve is
    identical, the pinned solve from the carried pinned state equals
    the JAX one to 1e-10, and a full round (master, cuts, add) agrees
    again."""
    jb, pb = _uc_pair()
    j = JaxLShaped(jb, dict(_UC_OPTS), dtype=jnp.float64)
    j.set_eta_bounds()
    st_off = _carry_arrays(j, pinned=False)[0]
    p = LShapedMethod(pb, dict(_UC_OPTS), device="cpu")
    from_numpy_state(p, {"qp_state": st_off}, prox_on=False)
    p._lb_master = np.array(j._lb_master)
    xf_j, _, lb_j = j.solve_master()
    xf_p, _, lb_p = p.solve_master()
    assert lb_p == lb_j
    np.testing.assert_array_equal(xf_p, xf_j)
    cj = j.generate_cuts(xf_j)
    cp = p.generate_cuts(xf_p)
    assert np.isfinite(cj[0]).any()
    _assert_round_matches(cj, cp, j.round_nonants(xf_j), j, p)

    for _ in range(2):
        xf, _, _ = j.solve_master()
        j.add_cuts(*j.generate_cuts(xf)[:2])
    st_off, st_fix, master = _carry_arrays(j)
    p = LShapedMethod(pb, dict(_UC_OPTS), device="cpu")
    from_numpy_state(p, {"qp_state": st_off}, prox_on=False)
    from_numpy_state(p, {"qp_state": st_fix, "master": master},
                     prox_on=False, fixed=True)
    p._last_master_x = np.array(j._last_master_x)
    p._cut_round = j._cut_round
    np.testing.assert_array_equal(p._mA, j._mA)
    np.testing.assert_array_equal(p._slots_filled, j._slots_filled)
    # the pinned solve from the carried pinned state
    xf_j, eta_j, lb_j = j.solve_master()
    xf_p, eta_p, lb_p = p.solve_master()
    assert lb_p == lb_j
    np.testing.assert_array_equal(xf_p, xf_j)
    np.testing.assert_array_equal(eta_p, eta_j)
    xr = j.round_nonants(xf_j)
    for e in (j, p):
        e.fix_nonants(xr)
        e.solve_loop(w_on=False, prox_on=False, update=False, fixed=True)
        e.unfix_nonants()
    assert p._kernel_plans[("fixed", False)].backend == "cuda"
    for name in ("x", "yA", "yB"):
        a, b = np.asarray(getattr(j, name)), getattr(p, name).numpy()
        assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(a).max()), \
            name
    # a full round: the pinned state is dropped and rebuilt from the
    # carried prox-off state in both packages
    from_numpy_state(p, {"qp_state": st_fix}, prox_on=False, fixed=True)
    _assert_round_matches(j.generate_cuts(xf_j), p.generate_cuts(xf_p),
                          xr, j, p)


def test_master_template_equals_jax():
    """The master built from the same batch: rows, bounds, cost and the
    first-stage row selection equal the JAX engine's, with and without
    in-master scenarios."""
    for opts in ({}, {"master_scenarios": [1]}):
        j = JaxLShaped(_jax_farmer(), dict(opts), dtype=jnp.float64)
        p = LShapedMethod(_farmer(), dict(opts), device="cpu")
        for name in ("_mA", "_ml", "_mu", "_lb_master", "_ub_master",
                     "_q_master", "_first_rows"):
            np.testing.assert_array_equal(getattr(p, name),
                                          getattr(j, name), err_msg=name)
        assert p._obj_const == j._obj_const
        assert p._eta_scens == j._eta_scens


@pytest.mark.parametrize("chunk", [0, 2], ids=["unchunked", "chunked"])
def test_cuts_never_warm_start_from_the_previous_point(chunk):
    """generate_cuts drops the engine's pinned state before every cut
    solve, the chunked mode's per-chunk states too (subproblem_chunk
    below S), so the cuts at a point are a function of that point:
    the same point twice, with another point solved in between, gives
    the same cuts bit for bit."""
    _, pb = _uc_pair(S=4)
    e = LShapedMethod(pb, dict(_UC_OPTS, subproblem_chunk=chunk,
                               subproblem_hospital=False), device="cpu")
    e.set_eta_bounds()
    xa, _, _ = e.solve_master()
    first = e.generate_cuts(xa)
    if chunk:
        assert ("fixed", False) in e._chunk_states
    e.generate_cuts(np.clip(xa + 0.5, 0.0, 1.0))
    again = e.generate_cuts(xa)
    for a, b in zip(first[:2], again[:2]):
        np.testing.assert_array_equal(a, b)
    assert first[2] == again[2]


def test_cuts_continue_the_solve_at_a_repeated_point():
    """When the master returns the point of the last cut solve (the
    last cuts were too weak to move it), the pinned solve continues
    from its own state at that point instead of rebuilding it cold,
    which would return the same cut: the second solve starts converged
    and runs a fraction of the first's steps."""
    e = LShapedMethod(_farmer(), {"max_iter": 5}, device="cpu")
    e.set_eta_bounds()
    xa, _, _ = e.solve_master()
    e.generate_cuts(xa)
    first = e._qp_states[("fixed", False)]
    e.generate_cuts(xa)
    again = e._qp_states[("fixed", False)]
    assert again is not first
    assert int(again.iters) < int(first.iters) // 4


def test_cuts_at_a_repeated_infeasible_point_start_cold():
    """A pinned solve that failed the engine's feasibility test is not
    continued: its iterates diverge (calculate_incumbent drops such a
    state too), so the same point again is solved cold and gives the
    same cuts bit for bit. UC 3x6's second master point breaks the
    pinned LP on the slice's block options."""
    _, pb = _uc_pair()
    e = LShapedMethod(pb, dict(_UC_OPTS), device="cpu")
    e.set_eta_bounds()
    for _ in range(2):
        xf, _, _ = e.solve_master()
        cuts = e.generate_cuts(xf)
        e.add_cuts(*cuts[:2])
    assert not e._cut_timing["feasible"] and e._last_cut_solve is None
    again = e.generate_cuts(xf)
    for a, b in zip(cuts[:2], again[:2]):
        np.testing.assert_array_equal(a, b)


def test_cut_dual_selection_keeps_the_deepest_witness_free_duals():
    """The same cold pinned solve on farmer(3) at the first master point,
    with the default dual selection and inside
    qp_solver.cut_dual_selection: the latter's cuts are finite and at
    least as deep at the point as the former's, scenario by scenario
    (the default lets the witness rescue a candidate whose cut is
    -inf)."""
    e = LShapedMethod(_farmer(), {"max_iter": 5}, device="cpu")
    e.set_eta_bounds()
    xa, _, _ = e.solve_master()
    xr = e.round_nonants(xa)
    vals = []
    for ctx in (contextlib.nullcontext, qp_solver.cut_dual_selection):
        e._qp_states.pop(("fixed", False), None)
        e.fix_nonants(xr)
        with ctx():
            e.solve_loop(w_on=False, prox_on=False, update=False,
                         fixed=True)
        d0 = e._data_with_prox(False)
        pin = torch.as_tensor(xr).expand(3, 3)
        d = d0._replace(lb=d0.lb.index_copy(1, e.nonant_idx, pin),
                        ub=d0.ub.index_copy(1, e.nonant_idx, pin))
        b0 = torch.zeros((3, e.batch.n), dtype=torch.float64
                         ).index_copy(1, e.nonant_idx, pin)
        pmask = torch.zeros(e.batch.n, dtype=torch.bool)
        pmask[e.nonant_idx] = True
        const, g = qp_solver.benders_cut(d, e.c, e.c0, e.yA, e.yB, pmask,
                                         b0)
        vals.append((const + (g * b0).sum(-1)).numpy())
        e.unfix_nonants()
    default, deepest = vals
    assert np.all(np.isfinite(deepest))
    assert np.all(deepest >= default - 1e-9 * np.abs(deepest))


@pytest.mark.parametrize("S", [3, 4, 6, 7, 8, 9])
@pytest.mark.parametrize("ms", [0, 1, 2])
def test_master_scenarios_reach_the_ef(S, ms):
    """One scenario in the master on farmer(S): the run reaches the EF
    (the independent HiGHS LP of tests/test_models.py) at
    tests/test_lshaped.py's bars (rel 2e-3 on both bounds), bounds on
    their sides to 1e-6, as the JAX package's runs do. Before the cut solves
    kept witness-free duals and continued at a repeated point, four of
    these runs (S = 3 and 4 with [0] and [1]) stopped on a -inf or weak
    cut far from the EF."""
    from test_models import ef_linprog
    batch = _farmer(S)
    ef_obj = ef_linprog(batch)
    ls = LShapedMethod(batch, {"max_iter": 40, "master_scenarios": [ms]},
                       device="cpu")
    lb, ub, _ = ls.lshaped_algorithm()
    assert lb == pytest.approx(ef_obj, rel=2e-3)
    assert ub == pytest.approx(ef_obj, rel=2e-3)
    tol = 1e-6 * abs(ef_obj)
    assert lb <= ef_obj + tol and ub >= ef_obj - tol


def test_farmer_rounds_from_carried_jax_state():
    """Round by round along the JAX engine's master_scenarios=[0] run on
    farmer(3) (tests/test_lshaped.py), the port starts each round from
    the JAX engine's prox-off state and cut buffer: the master solve is
    identical, the round's incumbent value agrees to 1e-6, every cut
    that is finite in the JAX package is finite in the port, and both
    packages' cuts hold at the round's point against the JAX pinned
    objective (tests/test_lshaped.py's bar). The depth of a cut at its
    point is not held: the two packages' pinned ADMM runs from the same
    state split at the first rho adaptation (ROADMAP.md C.1), and on
    this run the cuts at the point agree within 0.44 (9e-6 relative)
    in 17 of the 18 (round, scenario) cells;
    in round 3 the port's
    scenario 2 cut is 1.3e7 below the JAX one (its ADMM and polish
    candidates leave a reduced cost of -5e-4 on an unbounded column,
    and only the first polish candidate certifies a finite cut)."""
    opts = {"max_iter": 40, "master_scenarios": [0]}
    j = JaxLShaped(_jax_farmer(), dict(opts), dtype=jnp.float64)
    j.set_eta_bounds()
    for _ in range(6):
        st_off, _, master = _carry_arrays(j, pinned=False)
        p = LShapedMethod(_farmer(), dict(opts), device="cpu")
        from_numpy_state(p, {"qp_state": st_off, "master": master},
                         prox_on=False)
        p._last_master_x = (None if j._last_master_x is None
                            else np.array(j._last_master_x))
        p._cut_round = j._cut_round
        xf_j, eta_j, lb_j = j.solve_master()
        xf_p, eta_p, lb_p = p.solve_master()
        assert lb_p == lb_j
        np.testing.assert_array_equal(xf_p, xf_j)
        cj = j.generate_cuts(xf_j)
        V = np.asarray(j._last_base_obj)
        cp = p.generate_cuts(xf_p)
        assert cj[2] is not None and cp[2] == pytest.approx(cj[2], rel=1e-6)
        assert np.all(np.isfinite(cp[0][np.isfinite(cj[0])]))
        bar = V + 1e-4 * np.maximum(1.0, np.abs(V))
        for const, g, _ in (cj, cp):
            assert np.all(const + g @ xf_j <= bar)
        j.add_cuts(cj[0], cj[1])


# ---- tests/test_lshaped.py on the port ----

def test_lshaped_converges_to_ef():
    """farmer(3): LB below, UB above, both at the EF optimum within the
    JAX test's bars, the optimal plan; the JAX engine reaches the same
    point on the same batch."""
    ls = LShapedMethod(_farmer(), {"max_iter": 40}, device="cpu")
    lb, ub, xf = ls.lshaped_algorithm()
    assert lb <= EF_OBJ + 1.0
    assert ub >= EF_OBJ - 1.0
    assert lb == pytest.approx(EF_OBJ, rel=2e-3)
    assert ub == pytest.approx(EF_OBJ, rel=2e-3)
    assert xf == pytest.approx([170.0, 80.0, 250.0], abs=3.0)
    j_lb, j_ub, j_xf = JaxLShaped(_jax_farmer(), {"max_iter": 40},
                                  dtype=jnp.float64).lshaped_algorithm()
    assert lb == pytest.approx(j_lb, rel=2e-3)
    assert ub == pytest.approx(j_ub, rel=2e-3)
    assert xf == pytest.approx(j_xf, abs=3.0)
    assert len(ls.lshaped_timing) == ls._iter
    assert all(r["master_s"] >= 0 for r in ls.lshaped_timing)


def test_lshaped_cut_validity():
    """Every cut minorizes the true value function at a random probe
    point (the certified-cut invariant)."""
    batch = _farmer()
    ls = LShapedMethod(batch, {"max_iter": 5}, device="cpu")
    ls.set_eta_bounds()
    rng = np.random.RandomState(0)
    b_probe = rng.uniform(0.0, 250.0, size=batch.K)
    ev = PHBase(batch, {"subproblem_max_iter": 20000,
                        "subproblem_eps": 1e-10}, device="cpu")
    ev.fix_nonants(b_probe)
    ev.solve_loop(w_on=False, prox_on=False, update=False)
    V_true = ev._last_base_obj.numpy()
    xf, eta, lb = ls.solve_master()
    const, g, ub = ls.generate_cuts(xf)
    cut_at_probe = const + g @ b_probe
    assert np.all(cut_at_probe
                  <= V_true + 1e-4 * np.maximum(1, np.abs(V_true)))


def test_scenarios_in_master():
    """The in-master-scenarios variant (tests/test_lshaped.py): carrying
    one scenario's full second stage in the master converges to the
    same EF optimum, at the JAX test's bars, and with every scenario in
    the master the first master solve is the EF."""
    ls = LShapedMethod(_farmer(), {"max_iter": 40, "master_scenarios": [0]},
                       device="cpu")
    lb, ub, xf = ls.lshaped_algorithm()
    assert lb == pytest.approx(EF_OBJ, rel=2e-3)
    assert ub == pytest.approx(EF_OBJ, rel=2e-3)
    assert xf == pytest.approx([170.0, 80.0, 250.0], abs=3.0)
    assert ls._master_scens == [0] and ls._eta_scens == [1, 2]
    ls_all = LShapedMethod(_farmer(), {"max_iter": 3,
                                       "master_scenarios": [0, 1, 2]},
                           device="cpu")
    lb_all, _, _ = ls_all.lshaped_algorithm()
    assert lb_all == pytest.approx(EF_OBJ, rel=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        LShapedMethod(_farmer(), {"master_scenarios": [3]}, device="cpu")


def test_lshaped_refuses_multistage():
    from mpisppy_tpu_torch.models import hydro
    with pytest.raises(ValueError, match="two-stage only"):
        LShapedMethod(build_batch(hydro.scenario_creator,
                                  hydro.make_tree((3, 3))), device="cpu")


def test_lshaped_hub_with_xhat_spoke():
    batch = _farmer()
    opts = {"max_iter": 40, "defaultPHrho": 10.0}
    hub_dict = {
        "hub_class": LShapedHub,
        "hub_kwargs": {"options": {"rel_gap": 1e-3}},
        "opt_class": LShapedMethod,
        "opt_kwargs": {"batch": batch, "options": opts, "device": "cpu"},
    }
    spoke_dicts = [
        {"spoke_class": XhatLShapedInnerBound, "opt_class": PHBase,
         "opt_kwargs": {"batch": batch, "options": opts, "device": "cpu"}},
    ]
    wheel = spin_the_wheel(hub_dict, spoke_dicts)
    assert wheel.best_outer_bound <= EF_OBJ + 1.0
    assert np.isfinite(wheel.best_outer_bound)
    if np.isfinite(wheel.best_inner_bound):
        assert wheel.best_inner_bound >= EF_OBJ - 1.0


def _netdes_buffers(S, iters, small):
    def mk():
        return build_batch(netdes.scenario_creator, netdes.make_tree(S))
    big = LShapedMethod(mk(), {"max_iter": iters, "cuts_per_scenario": 64},
                        device="cpu")
    lb_big, ub_big, _ = big.lshaped_algorithm()
    sm = LShapedMethod(mk(), {"max_iter": iters,
                              "cuts_per_scenario": small}, device="cpu")
    lb_small, ub_small, _ = sm.lshaped_algorithm()
    return lb_big, ub_big, lb_small, ub_small, sm


def test_small_cut_buffer_evicts_and_matches_unlimited():
    """Slack-aware eviction on a netdes small enough for every run: a
    buffer of 2 slots per scenario fills and evicts, and still reaches
    the bound of an effectively unlimited buffer (tests/test_lshaped.py's
    bars)."""
    lb_big, ub_big, lb_small, ub_small, sm = _netdes_buffers(6, 12, 2)
    assert sm._cut_round > sm.cut_slots       # the buffer evicted
    assert (sm._slots_filled == sm.cut_slots).all()
    assert lb_small == pytest.approx(lb_big, rel=1e-5)
    assert ub_small == pytest.approx(ub_big, rel=1e-4)


@pytest.mark.slow
def test_small_cut_buffer_matches_unlimited():
    """tests/test_lshaped.py::test_small_cut_buffer_matches_unlimited on
    the port: 20-scenario netdes, 4 slots against 64."""
    lb_big, ub_big, lb_small, ub_small, _ = _netdes_buffers(20, 30, 4)
    assert lb_small == pytest.approx(lb_big, rel=1e-5)
    assert ub_small == pytest.approx(ub_big, rel=1e-4)


# ---- per-scenario rho on a shared-structure batch ----

def test_per_scenario_rho_on_shared_batch_matches_jax():
    """An (S, K) rho on a shared-A batch takes the batched (S, m, n)
    form in both packages. From the JAX engine's state after iter 0
    (W, x̄ and the prox-off solver state carried), one prox-on
    iteration of 50 block steps at fixed rho (no adaptation inside the
    budget): x and x̄ equal to 1e-10 and W to 1e-9 relative (one rho
    multiplication of the x difference, and conv, a difference of
    the two, at 1e-9 as tests/test_torch_ph.py holds it after a carried
    iteration); the block's scope declines
    the 3-D A (the reference route, as in the JAX package)."""
    jb, pb = _uc_pair()
    opts = {"defaultPHrho": 10.0, "subproblem_max_iter": 50,
            "subproblem_kernel_mode": "fused",
            "subproblem_kernel_backend": "pallas",
            "subproblem_polish_hot": False}
    j = JaxPH(jb, dict(opts), dtype=jnp.float64)
    p = PH(pb, dict(opts), device="cpu")
    rho = np.random.RandomState(0).uniform(5.0, 20.0, size=(jb.S, jb.K))
    j.solve_loop(w_on=False, prox_on=False, update=True)
    j.Update_W()
    st = j._qp_states[False]
    arrays = {"W": np.asarray(j.W), "xbar": np.asarray(j.xbar), "rho": rho,
              "qp_state": {k: np.asarray(getattr(st, k)) for k in
                           ("x", "yA", "yB", "zA", "zB", "rho_scale")}}
    arrays["qp_state"]["F"] = np.asarray(st.L)
    from_numpy_state(p, arrays, prox_on=False)
    j.rho = jnp.asarray(rho)
    j.invalidate_factors()
    j.solve_loop()
    p.solve_loop()
    fac, d = p._get_factors(True)
    assert d.A.ndim == 3 and fac.A_s.shape == (pb.S, pb.m, pb.n)
    assert p._kernel_plans[True].backend == "reference"

    def rel(a, b):
        a = np.asarray(a)
        return np.abs(a - b.numpy()).max() / max(1.0, np.abs(a).max())

    assert rel(j.x, p.x) <= 1e-10
    assert rel(j.xbar, p.xbar) <= 1e-10
    assert rel(j.W_new, p.W_new) <= 1e-9
    assert p.conv == pytest.approx(j.conv, rel=1e-9)


def test_per_scenario_rho_refused_for_split_data():
    """df32 data cannot broadcast to the batched form: ValueError, as in
    the JAX package."""
    _, pb = _uc_pair()
    p = PHBase(pb, {"subproblem_precision": "df32"}, device="cpu")
    p.rho = p.rho * torch.linspace(1.0, 2.0, pb.S,
                                   dtype=p.rho.dtype).unsqueeze(-1)
    with pytest.raises(ValueError, match="per-scenario rho"):
        p._data_with_prox(True)
