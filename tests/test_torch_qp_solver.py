"""The port's ADMM QP solver (mpisppy_tpu_torch.ops.qp_solver) against
the JAX package's on the same inputs: the tiny shared QP of
tests/test_kernels.py and farmer's batched-A QP, both in f64 on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import farmer as jax_farmer
from mpisppy_tpu.ops import qp_solver as J
from mpisppy_tpu_torch.ops import qp_solver as T
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tiny_arrays(S=3, m=6, n=4, seed=0):
    """tests/test_kernels.py:_tiny_qp's data, as numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    P = np.abs(rng.normal(size=n)) + 0.5
    mid = rng.normal(size=(S, m))
    data = (P, A, mid - 3.0, mid + 3.0, np.full((S, n), -5.0),
            np.full((S, n), 5.0))
    return data, rng.normal(size=(S, n))


def _farmer_arrays():
    b = jax_build_batch(jax_farmer.scenario_creator,
                        jax_farmer.make_tree(3))
    return (b.P_diag, b.A, b.l, b.u, b.lb, b.ub), b.c


CASES = {"tiny": _tiny_arrays, "farmer": _farmer_arrays}


def _both(case):
    """(jax factors, data, q, cold state), (port ...) on one input."""
    data, q = CASES[case]()
    dj = J.QPData(*map(jnp.asarray, data))
    dt = T.QPData(*(torch.as_tensor(np.asarray(a)) for a in data))
    qj, qt = jnp.asarray(q), torch.as_tensor(q)
    fj, ft = J.qp_setup(dj, q_ref=qj), T.qp_setup(dt, q_ref=qt)
    return ((fj, dj, qj, J.qp_cold_state(fj, dj)),
            (ft, dt, qt, T.qp_cold_state(ft, dt)))


def _close(a_jax, a_port, tol):
    """|jax − port| ≤ tol × max(1, max|jax|): f64 with another order of
    summation, measured against the array's own magnitude."""
    a = np.asarray(a_jax)
    b = a_port.numpy()
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_and_factor_match(case):
    (fj, _, _, sj), (ft, _, _, st) = _both(case)
    for k in ("D", "E", "Eb", "cost_scale", "A_s", "P_s", "rho_A",
              "rho_b"):
        _close(getattr(fj, k), getattr(ft, k), 1e-13)
    _close(sj.L, st.L, 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("adaptive,iters", [(True, 5), (False, 50)])
def test_fixed_iteration_trace_matches(case, adaptive, iters):
    """check_every=1, eps 0, polish off: every iterate agrees at 1e-10.
    The adaptive-rho trace is held over 5 steps (the micro-parity length
    of tests/test_kernels.py:64): on the tiny QP one scenario's primal
    residual sits at roundoff (~1e-16), and the shared rho rule's
    geometric mean turns that noise into different stepsizes within a
    few adaptations in EITHER package."""
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(case)
    kw = dict(max_iter=iters, check_every=1, eps_abs=0.0, eps_rel=0.0,
              polish=False, adaptive_rho=adaptive)
    rj = J.qp_solve(fj, dj, qj, sj, **kw)
    rt = T.qp_solve(ft, dt, qt, st, **kw)
    assert rt[0].iters == int(rj[0].iters) == iters
    for f in ("x", "yA", "yB", "zA", "zB", "rho_scale", "pri_rel"):
        _close(getattr(rj[0], f), getattr(rt[0], f), 1e-10)
    _close(rj[1], rt[1], 1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_polished_solve_matches(case):
    """The tolerances of tests/test_kernels.py:379-396."""
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(case)
    kw = dict(max_iter=400, eps_abs=1e-8, eps_rel=1e-8, polish=True)
    rj = J.qp_solve(fj, dj, qj, sj, **kw)
    rt = T.qp_solve(ft, dt, qt, st, **kw)
    assert float(rt[0].pri_rel.max()) < 1e-6
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_driver_matches(case):
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(case)
    kw = dict(max_iter=300, segment=100, eps_abs=1e-8, eps_rel=1e-8,
              polish=True)
    rj = J.qp_solve_segmented(fj, dj, qj, sj, **kw)
    rt = T.qp_solve_segmented(ft, dt, qt, st, **kw)
    assert rt[0].iters == int(rj[0].iters)
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_objective_bounds_primal(case):
    """Weak duality: the certified dual objective of the polished duals
    sits at or below the primal objective of the polished point (which
    is feasible to the solve tolerance)."""
    _, (ft, dt, qt, st) = _both(case)
    st, x, yA, yB = T.qp_solve(ft, dt, qt, st, max_iter=400,
                               eps_abs=1e-8, eps_rel=1e-8, polish=True)
    dual = T.qp_dual_objective(dt, qt, 0.0, yA, yB, x_witness=x)
    primal = 0.5 * torch.sum(dt.P_diag * x * x, dim=-1) \
        + torch.sum(qt * x, dim=-1)
    assert torch.all(torch.isfinite(dual))
    assert torch.all(dual <= primal + 1e-6 * (1.0 + primal.abs()))
    # and it is the JAX package's bound on the same duals
    dj = J.QPData(*(jnp.asarray(a.numpy()) for a in dt))
    ref = J.qp_dual_objective(dj, jnp.asarray(qt.numpy()), 0.0,
                              jnp.asarray(yA.numpy()),
                              jnp.asarray(yB.numpy()),
                              x_witness=jnp.asarray(x.numpy()))
    np.testing.assert_allclose(dual.numpy(), np.asarray(ref), rtol=1e-12)


def test_repair_and_state_duals_match():
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both("tiny")
    rj = J.qp_solve(fj, dj, qj, sj, max_iter=50, polish=False)
    rt = T.qp_solve(ft, dt, qt, st, max_iter=50, polish=False)
    for a, b in zip(J.qp_state_duals(fj, rj[0]), T.qp_state_duals(ft, rt[0])):
        _close(a, b, 1e-10)
    y = np.array([[1.0, -1.0, 2.0]])
    lo = np.array([[-np.inf, 0.0, 0.0]])
    hi = np.array([[0.0, np.inf, 1.0]])
    ref = J.qp_repair_duals(*map(jnp.asarray, (lo, hi, lo, hi, y, y)))
    got = T.qp_repair_duals(*(torch.as_tensor(a)
                              for a in (lo, hi, lo, hi, y, y)))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("case", sorted(CASES))
def test_setup_like_and_reset_rho_match(case):
    """A related mode's factors reuse the base equilibration (prox-like
    P change, pinned boxes), and a rho reset refactorizes at scale 1."""
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(case)
    P2 = np.asarray(dj.P_diag) + 2.0
    lb2 = np.asarray(dj.lb).copy()
    lb2[:, 0] = np.asarray(dj.ub)[:, 0]
    lj = J.qp_setup_like(fj, dj._replace(P_diag=jnp.asarray(P2),
                                        lb=jnp.asarray(lb2)))
    lt = T.qp_setup_like(ft, dt._replace(P_diag=torch.as_tensor(P2),
                                        lb=torch.as_tensor(lb2)))
    assert lt.A_s is ft.A_s
    for k in ("P_s", "rho_A", "rho_b"):
        _close(getattr(lj, k), getattr(lt, k), 1e-13)
    kw = dict(max_iter=100, check_every=25, eps_abs=0.0, eps_rel=0.0,
              polish=False)
    rj = J.qp_reset_rho(fj, J.qp_solve(fj, dj, qj, sj, **kw)[0])
    rt = T.qp_reset_rho(ft, T.qp_solve(ft, dt, qt, st, **kw)[0])
    np.testing.assert_array_equal(rt.rho_scale.numpy(), 1.0)
    _close(rj.L, rt.L, 1e-12)
    _close(rj.x, rt.x, 1e-10)
