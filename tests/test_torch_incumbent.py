"""The port's incumbent surfaces against the JAX package's, on the same
scenario batches: nonant fixing with the fixed-mode solve,
calculate_incumbent (with its drop of a diverged state), the integer
dive, the batched pool evaluation, ops/incumbent and core/mip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import mip as jax_mip
from mpisppy_tpu.core.ph import PH as JaxPH, PHBase as JaxPHBase
from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer, uc as jax_uc
from mpisppy_tpu.ops import incumbent as jax_inc
from mpisppy_tpu_torch.core import mip
from mpisppy_tpu_torch.core.ph import PH, PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import farmer, uc
from mpisppy_tpu_torch.ops import incumbent as inc

_UC_KW = {"num_gens": 3, "num_hours": 6}
_UC_INT = {**_UC_KW, "relax_integrality": False}
_FARMER = {"defaultPHrho": 10.0, "PHIterLimit": 3, "convthresh": -1.0,
           "subproblem_max_iter": 4000}
_UC = {"defaultPHrho": 100.0, "PHIterLimit": 3, "convthresh": -1.0,
       "subproblem_max_iter": 4000}


def _h(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel_close(ref, got, tol):
    ref, got = _h(ref), _h(got)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _farmer_pair(S=3):
    return (jax_build_batch(jax_farmer.scenario_creator,
                            jax_farmer.make_tree(S)),
            build_batch(farmer.scenario_creator, farmer.make_tree(S)))


def _uc_pair(S=3, kw=_UC_KW):
    return (jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                            creator_kwargs=kw,
                            vector_patch=jax_uc.scenario_vector_patch),
            build_batch(uc.scenario_creator, uc.make_tree(S),
                        creator_kwargs=kw,
                        vector_patch=uc.scenario_vector_patch))


def _engines(pair, opts, cls=(JaxPHBase, PHBase)):
    bj, bp = pair
    return (cls[0](bj, dict(opts), dtype=jnp.float64),
            cls[1](bp, dict(opts), device="cpu"))


# ---- fix_nonants + the fixed-mode solve ----

def _uc_pin_mask(batch):
    col = np.zeros(batch.n, bool)
    col[batch.template.var_slices["u"]] = True
    return col[np.asarray(batch.nonant_idx)]


@pytest.mark.parametrize("model", ["farmer", "uc"])
def test_fixed_solve_matches_jax(model):
    """Both engines pin the same nonant values and run one fixed-mode
    prox-off solve: x at 1e-8, the expected objective at 1e-6 relative,
    the primal residuals at 1e-8 of their scale (the solves adapt
    rho). Farmer pins every slot at the EF first stage; UC pins the
    commitments at one scenario's iter-0 plan (rounded) and leaves the
    startups to the solve."""
    if model == "farmer":
        j, p = _engines(_farmer_pair(), _FARMER)
        vals, mask = np.array([170.0, 80.0, 250.0]), None
    else:
        j, p = _engines(_uc_pair(), _UC)
        j.solve_loop(w_on=False, prox_on=False, update=False)
        vals = j.round_nonants(np.asarray(j._hub_nonants())[0])
        mask = _uc_pin_mask(j.batch)
    for e in (j, p):
        e.fix_nonants(vals, mask=mask)
        e.solve_loop(w_on=False, prox_on=False, update=False, fixed=True)
    np.testing.assert_array_equal(_h(p._fixed_mask), _h(j._fixed_mask))
    _rel_close(j.x, p.x, 1e-8)
    assert p.Eobjective_value() == pytest.approx(j.Eobjective_value(),
                                                 rel=1e-6)
    sj, sp = j._qp_states[("fixed", False)], p._qp_states[("fixed", False)]
    # the relative residual at 1e-8; the absolute one at 1e-8 of the
    # problem scale it is measured against (pri_res / pri_rel)
    np.testing.assert_allclose(_h(sp.pri_rel), _h(sj.pri_rel), rtol=0,
                               atol=1e-8)
    scale = float(np.max(_h(sj.pri_res) / np.maximum(_h(sj.pri_rel),
                                                     1e-300)))
    np.testing.assert_allclose(_h(sp.pri_res), _h(sj.pri_res), rtol=0,
                               atol=1e-8 * scale)
    assert sp.iters == int(sj.iters)
    # pinned slots sit at their values; unfix releases them
    xn = _h(p._hub_nonants())
    m = np.ones_like(xn, bool) if mask is None \
        else np.broadcast_to(mask, xn.shape)
    np.testing.assert_allclose(xn[m], np.broadcast_to(vals, xn.shape)[m],
                               atol=1e-6 * max(1.0, np.abs(vals).max()))
    p.unfix_nonants()
    assert not bool(p._fixed_mask.any())


# ---- calculate_incumbent ----

def test_calculate_incumbent_farmer_matches_jax():
    """A feasible x̂ gives the same Eobjective at 1e-6 relative; an
    infeasible one returns None in both packages; the next call after
    the infeasible one still matches (its diverged state was dropped).
    The engine's own solutions and fixings survive each call."""
    j, p = _engines(_farmer_pair(), _FARMER, cls=(JaxPH, PH))
    j.solve_loop(w_on=False, prox_on=False)
    p.solve_loop(w_on=False, prox_on=False)
    x_before = p.x.clone()
    good = np.array([170.0, 80.0, 250.0])
    bad = np.array([500.0, 500.0, 500.0])     # beyond the 500-acre land
    for xhat, feasible in ((good, True), (bad, False),
                           (np.array([150.0, 100.0, 250.0]), True)):
        vj = j.calculate_incumbent(xhat)
        vp = p.calculate_incumbent(xhat)
        if not feasible:
            assert vj is None and vp is None
            assert ("fixed", False) not in p._qp_states
            continue
        assert vj is not None and vp is not None
        assert vp == pytest.approx(vj, rel=1e-6)
    assert torch.equal(p.x, x_before)
    assert not bool(p._fixed_mask.any())


# ---- the dive and the pool ----

def test_dive_candidates_and_pool_match_jax():
    """UC 3 x 6 with integer commitments: the dived per-scenario
    candidates and their feasible mask are equal, and the pool
    evaluation of a deterministic pool built from them gives the same
    feasibility verdict and objectives at 1e-6."""
    pair = _uc_pair(kw=_UC_INT)
    j, p = _engines(pair, _UC)
    for e in (j, p):
        e.solve_loop(w_on=False, prox_on=False, update=False)
    X = np.asarray(j._hub_nonants())
    pin = _uc_pin_mask(j.batch)
    cj, fj = j.dive_nonant_candidates(X, dive_slots=pin)
    cp, fp = p.dive_nonant_candidates(X, dive_slots=pin)
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(cp[:, pin], cj[:, pin])
    np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-6)
    b = j.batch
    idx = np.asarray(b.nonant_idx)
    lb_row, ub_row = np.asarray(b.lb)[0][idx], np.asarray(b.ub)[0][idx]
    imask = j.nonant_integer_mask
    dive = imask & pin & ((ub_row - lb_row) <= 1.0 + 1e-9)
    kw = dict(thresholds=(0.3, 0.7), flips=2, n_random=0)
    pool_j = np.asarray(jax_inc.build_pool(cj, np.asarray(b.prob), dive,
                                           imask, lb_row, ub_row, **kw))
    pool_p = inc.build_pool(cp, np.asarray(b.prob), dive, imask, lb_row,
                            ub_row, **kw)
    np.testing.assert_array_equal(pool_p.numpy(), pool_j)
    oj, vj = j.evaluate_incumbent_pool(pool_j, pin_mask=pin)
    op, vp = p.evaluate_incumbent_pool(pool_p, pin_mask=pin)
    np.testing.assert_array_equal(vp, vj)
    assert vp.any()
    np.testing.assert_allclose(op[vp], oj[vj], rtol=1e-6)


# ---- ops/incumbent ----

def _pool_inputs(seed=3, S=5, K=12):
    rng = np.random.RandomState(seed)
    X = rng.rand(S, K)
    prob = rng.rand(S)
    prob /= prob.sum()
    dive = rng.rand(K) < 0.6
    imask = dive | (rng.rand(K) < 0.2)
    lb, ub = np.zeros(K), np.ones(K)
    return X, prob, dive, imask, lb, ub


def test_slam_rows_and_pool_size_match_jax():
    X = _pool_inputs()[0]
    for a, b in zip(inc.slam_rows(X), jax_inc.slam_rows(X)):
        np.testing.assert_array_equal(a, b)
    for n_dive in (0, 1, 5, 20):
        assert inc.pool_size(n_dive) == jax_inc.pool_size(n_dive)
        assert inc.pool_size(n_dive, (0.5,), 3, 2) \
            == jax_inc.pool_size(n_dive, (0.5,), 3, 2)


def test_build_pool_matches_jax():
    """Every deterministic row (votes, flips, slams, bounds) equal at
    1e-12. The seeded random rows come from torch's generator, not
    jax's threefry, so they are held to what they are: the base
    candidate with exactly ``ball`` distinct dive slots flipped,
    reproducible per (seed, round) and fresh across rounds."""
    X, prob, dive, imask, lb, ub = _pool_inputs()
    kw = dict(thresholds=(0.3, 0.5, 0.7), flips=4, n_random=3, ball=2,
              seed=7, round_index=1)
    pj = np.asarray(jax_inc.build_pool(X, prob, dive, imask, lb, ub, **kw))
    pp = inc.build_pool(X, prob, dive, imask, lb, ub, **kw).numpy()
    assert pp.shape == pj.shape == (inc.pool_size(dive.sum(),
                                                  kw["thresholds"], 4, 3),
                                    X.shape[1])
    det = np.r_[0:7, 10:14]           # votes + flips, slams + bounds
    np.testing.assert_allclose(pp[det], pj[det], rtol=0, atol=1e-12)
    base = pp[1]                       # the tau = 0.5 vote row
    rand = pp[7:10]
    assert ((rand != base).sum(axis=1) == 2).all()
    assert not (rand != base)[:, ~dive].any()
    again = inc.build_pool(X, prob, dive, imask, lb, ub, **kw).numpy()
    np.testing.assert_array_equal(again, pp)
    other = inc.build_pool(X, prob, dive, imask, lb, ub,
                           **{**kw, "round_index": 2}).numpy()
    assert not np.array_equal(other[7:10], rand)
    ro = inc.build_pool(X, prob, dive, imask, lb, ub,
                        **{**kw, "random_only": True}).numpy()
    assert ro.shape == pp.shape
    assert ((ro != base).sum(axis=1) == 2).all()
    assert inc.build_pool(X, prob, np.zeros_like(dive), imask,
                          random_only=True) is None


def test_pool_verdict_matches_jax():
    rng = np.random.RandomState(11)
    P, S = 4, 3
    obj = rng.randn(P * S) * 100.0
    pri_res = rng.rand(P * S) * 2e-4
    pri_rel = rng.rand(P * S) * 2e-4
    prob = np.array([0.2, 0.3, 0.5])
    live = np.array([True, True, False])
    vj = np.asarray(jax_inc.pool_verdict(
        jnp.asarray(obj), jnp.asarray(pri_res), jnp.asarray(pri_rel),
        jnp.asarray(prob), jnp.asarray(live), 1e-4, P=P, S=S))
    t = torch.as_tensor
    vp = inc.pool_verdict(t(obj), t(pri_res), t(pri_rel), t(prob),
                          t(live), 1e-4, P=P, S=S).numpy()
    np.testing.assert_allclose(vp, vj, rtol=0, atol=1e-12)


# ---- core/mip ----

def test_milp_solve_and_dive_integers_match_jax():
    """milp_solve equal to the JAX package's at 1e-9; dive_integers
    gives the same pins (the integer columns) and objectives at 1e-6,
    on UC 3 x 6 with integer commitments."""
    pair = _uc_pair(kw=_UC_INT)
    j, p = _engines(pair, _UC)
    fj, dj = j._get_factors(False)
    fp, dp = p._get_factors(False)
    imask = np.asarray(j.batch.integer)
    xj, oj, vj = jax_mip.milp_solve(dj, j.c, j.c0, imask)
    xp, op, vp = mip.milp_solve(dp, p.c, p.c0, imask)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(op, oj, rtol=1e-9)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-9 * max(
        1.0, np.abs(xj).max()))
    sj, sp = j._ensure_state(False), p._ensure_state(False)
    kw = dict(max_iter=1500, eps=1e-6, feas_tol=1e-3)
    xj, oj, vj, _ = jax_mip.dive_integers(fj, dj, j.c, j.c0, sj, imask, **kw)
    xp, op, vp, _ = mip.dive_integers(fp, dp, p.c, p.c0, sp, imask, **kw)
    np.testing.assert_array_equal(_h(vp), np.asarray(vj))
    ints = np.broadcast_to(imask, np.asarray(xj).shape)
    np.testing.assert_array_equal(_h(xp)[ints], np.asarray(xj)[ints])
    np.testing.assert_allclose(_h(op), np.asarray(oj), rtol=1e-6)
