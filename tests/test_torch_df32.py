"""The port's df32 and mixed solver pieces (split-f32 matrices, the
df32 factor and its L⁻¹ trade, qp_solve_mixed and the fused mixed
solve) against the JAX package's on the same inputs, built from the
same seed, on the CPU (the PH engine running them:
tests/test_torch_df32_ph.py).

Tolerances, each stated where it is checked, follow what the math
gives. torch and XLA sum f32 products in different orders, so a df32
quantity agrees with the JAX package's to the split's f32 accumulation
floor (~1e-7 relative per matvec), and ADMM amplifies that:
 - matvecs: against the exact f64 product, tests/test_precision.py's
   bars; the f32 factor: L Lᵀ against M at 1e-5;
 - one ADMM step from one state with the same factors: the port is no
   farther from the exact f64 step than twice the JAX package's own
   distance from it, and the two no farther apart than that;
 - whole solves: the JAX tests' own bars (tests/test_precision.py,
   tests/test_kernels.py).
The native-precision tests elsewhere keep their 1e-10 and 1e-9 bars."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.ir.batch import build_batch as jax_build_batch
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops import qp_solver as J
from mpisppy_tpu.ops.kernels import reference as JR
from mpisppy_tpu_torch.core.ph import PHBase
from mpisppy_tpu_torch.ir.batch import build_batch
from mpisppy_tpu_torch.models import uc
from mpisppy_tpu_torch.ops import kernels
from mpisppy_tpu_torch.ops import qp_solver as T
from mpisppy_tpu_torch.ops.kernels import reference as R
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(a):
    return torch.as_tensor(np.array(a))


def _uc_np(S=4, G=3, T_=6):
    """tests/test_precision.py:_uc_batch's QP, as numpy."""
    b = jax_build_batch(jax_uc.scenario_creator, jax_uc.make_tree(S),
                        creator_kwargs={"num_gens": G, "num_hours": T_,
                                        "relax_integrality": True})
    A = np.asarray(b.A_of(0), np.float64)
    vecs = [np.asarray(getattr(b, k), np.float64)
            for k in ("l", "u", "lb", "ub")]
    return np.asarray(b.P_diag)[0], A, vecs, np.asarray(b.c, np.float64)


def _split_qps(S=4):
    """The same split-A QP in both packages: (jax data, q, factors),
    (port data, q, factors)."""
    P, A, vecs, c = _uc_np(S)
    hi, lo = T.split_f32_np(A)
    dj = J.QPData(jnp.asarray(P), J.SplitMatrix(jnp.asarray(hi),
                                                jnp.asarray(lo)),
                  *map(jnp.asarray, vecs))
    qj = jnp.asarray(c)
    dp = T.QPData(_t(P), T.SplitMatrix(_t(hi), _t(lo)), *map(_t, vecs))
    qp = _t(c)
    return (dj, qj, J.qp_setup(dj, q_ref=qj)), (dp, qp, T.qp_setup(dp,
                                                                   q_ref=qp))


def _native_qp(S=4):
    P, A, vecs, c = _uc_np(S)
    d = T.QPData(_t(P), _t(A), *map(_t, vecs))
    q = _t(c)
    return d, q, T.qp_setup(d, q_ref=q)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.double().numpy() if hasattr(b, "numpy") else np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


# ---------------- representation and factor ----------------

def test_split_matvec_accuracy():
    """The three-pass split matvec agrees with exact f64 below 1e-6
    relative and is never worse than 1.5x plain f32
    (tests/test_precision.py:163), in both directions."""
    rng = np.random.RandomState(0)
    A = rng.randn(400, 300) * np.exp(rng.randn(400, 300) * 3)
    sp = T.split_f32(_t(A))
    for v, fn in ((rng.randn(5, 300) * 1e3, T._Ax),
                  (rng.randn(5, 400) * 1e3, T._ATy)):
        exact = v @ A.T if fn is T._Ax else v @ A
        got = fn(sp, _t(v)).numpy()
        plain = fn(_t(A).float(), _t(v).float()).double().numpy()
        scale = np.abs(exact).max()
        assert np.abs(got - exact).max() / scale < 1e-6
        assert np.abs(got - exact).max() \
            <= 1.5 * np.abs(plain - exact).max() + 1e-12 * scale
    np.testing.assert_array_equal(
        T.merged64(sp).numpy(), np.asarray(J.merged64(J.split_f32(
            jnp.asarray(A)))))


def test_split_setup_and_factor_match_jax():
    """df32 setup: the Ruiz scalings in f32 agree with the JAX package's
    to 1e-7 relative (one f32 ulp), the scaled split's f64 value to
    1e-6; the df32 factor is a finite f32 Cholesky factor with
    |L Lᵀ − M| ≤ 1e-5 |M| (tests/test_precision.py:186) and agrees with
    the JAX package's factor to 1e-5 relative."""
    (dj, qj, fj), (dp, qp, fp) = _split_qps()
    for k in ("D", "E", "Eb", "P_s", "rho_A", "rho_b"):
        assert _rel(getattr(fj, k), getattr(fp, k)) < 1e-7, k
    assert float(fp.cost_scale) == pytest.approx(float(fj.cost_scale),
                                                 rel=1e-7)
    assert _rel(np.asarray(J.merged64(fj.A_s)), T.merged64(fp.A_s)) < 1e-6
    L = T._factorize(fp, torch.ones((), dtype=torch.float64))
    assert L.dtype == torch.float32 and bool(torch.isfinite(L).all())
    A64 = T.merged64(fp.A_s).numpy()
    g = (fp.Eb * fp.D).numpy()
    M = A64.T @ (fp.rho_A.numpy()[:, None] * A64) \
        + np.diag(fp.P_s.numpy() + fp.sigma + g * g * fp.rho_b.numpy())
    L64 = L.double().numpy()
    assert np.abs(L64 @ L64.T - M).max() / np.abs(M).max() < 1e-5
    Lj = J._factorize(fj, jnp.ones((), jnp.float64))
    assert _rel(Lj, L) < 1e-5


def test_l_inv_matmul_vs_triangular_solve_parity():
    """x = L⁻ᵀ(L⁻¹ b) as two products agrees with the triangular solves
    and the exact solve within 8 κ·eps32 (tests/test_kernels.py:233)."""
    rng = np.random.default_rng(7)
    n = 48
    B = rng.normal(size=(n, n))
    M = B @ B.T + n * np.eye(n)
    L32 = torch.linalg.cholesky(_t(M).float())
    b = _t(rng.normal(size=(5, n)))
    x_exact = np.linalg.solve(M, b.numpy().T).T
    x_tri = T._chol_solve(L32, b).numpy()
    li = T.make_l_inv(L32)
    assert isinstance(li, T.LInv)
    assert torch.equal(li.tri, L32)
    x_inv = T._chol_solve(li, b).numpy()
    band = np.linalg.cond(M) * np.finfo(np.float32).eps
    scale = np.abs(x_exact).max()
    assert np.abs(x_tri - x_exact).max() / scale <= 8 * band
    assert np.abs(x_inv - x_exact).max() / scale <= 8 * band
    assert np.abs(x_inv - x_tri).max() / scale <= 8 * band
    # the inverse itself: the JAX package's, to 8 κ·eps32
    lj = J.make_l_inv(jnp.asarray(L32.numpy()))
    assert _rel(lj.inv, li.inv) <= 8 * band


def test_l_inv_profitability_check():
    """The break-even test (tests/test_kernels.py:257), equal to the
    JAX package's over a grid of shapes."""
    assert R.l_inv_profitable(n=13056, s_chunk=128, tail_iter=100)
    assert R.l_inv_profitable(n=13056, s_chunk=128, tail_iter=500)
    assert not R.l_inv_profitable(n=13056, s_chunk=1, tail_iter=100)
    for n in (48, 13056):
        for s in (1, 16, 128):
            for tail in (0, 100, 1000):
                for ir in (1, 2):
                    assert R.l_inv_profitable(n, s, tail, ir) \
                        == JR.l_inv_profitable(n, s, tail, ir)


@pytest.mark.parametrize("phase", ["bulk_f32", "tail_df32"])
def test_one_admm_step_matches_jax_to_the_split_floor(phase):
    """One ADMM step from the same warm state with the JAX package's
    factors: the f32 bulk step (hi part, f32 Cholesky solve) and the
    df32 tail step (split matvecs, one IR sweep). The exact f64 step is
    the yardstick: the port is no farther from it than twice the JAX
    package, and the two no farther apart than that (and below 1e-3
    relative)."""
    (dj, qj, fj), (dp, qp, _) = _split_qps()
    sj = J.qp_cold_state(fj, dj)
    kw = dict(check_every=1, eps_abs=0.0, eps_rel=0.0, adaptive_rho=False,
              polish=False)
    sj, _, _, _ = J.qp_solve(fj, dj, qj, sj, max_iter=3, **kw)
    fp = T.QPFactors(sigma=float(fj.sigma), D=_t(fj.D), E=_t(fj.E),
                     Eb=_t(fj.Eb), cost_scale=_t(fj.cost_scale),
                     A_s=T.SplitMatrix(_t(fj.A_s.hi), _t(fj.A_s.lo)),
                     P_s=_t(fj.P_s), rho_A=_t(fj.rho_A), rho_b=_t(fj.rho_b))
    sp = T.qp_cold_state(fp, dp)._replace(
        **{k: _t(getattr(sj, k)) for k in ("x", "yA", "yB", "zA", "zB",
                                            "L", "rho_scale")})
    if phase == "bulk_f32":
        fj = J._cast_floats(fj._replace(A_s=fj.A_s.hi), jnp.float32)
        dj = J._cast_floats(dj._replace(A=fj.A_s), jnp.float32)
        sj, qj = J._cast_floats(sj, jnp.float32), qj.astype(jnp.float32)
        fp = T._cast_floats(fp._replace(A_s=fp.A_s.hi), torch.float32)
        dp = T._cast_floats(dp._replace(A=fp.A_s), torch.float32)
        sp, qp = T._cast_floats(sp, torch.float32), qp.float()
    x0 = np.asarray(sj.x, np.float64)
    sj1, _, _, _ = J.qp_solve(fj, dj, qj, sj, max_iter=1, **kw)
    sp1, _, _, _ = T.qp_solve(fp, dp, qp, sp, max_iter=1, **kw)
    # the exact f64 step from the same state
    A64 = np.asarray(J.merged64(fj.A_s), np.float64) \
        if phase == "tail_df32" else np.asarray(fj.A_s, np.float64)
    f = {k: np.asarray(getattr(fj, k), np.float64)
         for k in ("D", "Eb", "P_s", "rho_A", "rho_b", "cost_scale")}
    st = {k: np.asarray(getattr(sj, k), np.float64)
          for k in ("yA", "yB", "zA", "zB")}
    rs = float(np.asarray(sj.rho_scale))
    g = f["Eb"] * f["D"]
    rA, rB = f["rho_A"] * rs, f["rho_b"] * rs
    sig = float(fj.sigma)
    q_s = f["cost_scale"] * f["D"] * np.asarray(qj, np.float64)
    rhs = sig * x0 - q_s + (rA * st["zA"] - st["yA"]) @ A64 \
        + g * (rB * st["zB"] - st["yB"])
    M = A64.T @ (rA[:, None] * A64) + np.diag(f["P_s"] + sig + g * g * rB)
    x_exact = 1.6 * np.linalg.solve(M, rhs.T).T - 0.6 * x0
    err_j = _rel(x_exact, np.asarray(sj1.x, np.float64))
    err_p = _rel(x_exact, sp1.x)
    diff = _rel(np.asarray(sj1.x, np.float64), sp1.x)
    assert err_p <= 2.0 * err_j + 1e-12
    assert diff <= 2.0 * err_j + 1e-12
    assert diff < 1e-3


# ---------------- solves ----------------

def _tiny(seed=1):
    """tests/test_kernels.py:_tiny_qp in the port."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(6, 4))
    P = np.abs(rng.normal(size=4)) + 0.5
    mid = rng.normal(size=(3, 6))
    arrs = (P, A, mid - 3.0, mid + 3.0, np.full((3, 4), -5.0),
            np.full((3, 4), 5.0))
    q = rng.normal(size=(3, 4))
    return arrs, q


@pytest.mark.parametrize("precision", ["mixed", "df32"])
def test_micro_parity_fused_mixed_vs_mixed_driver(precision):
    """With both phases inside one segment the fused solve is the
    segmented driver's arithmetic (tests/test_kernels.py:87): x and
    pri_rel at 1e-10, the same iteration count. The mixed case is also
    held against the JAX package's qp_solve_mixed: both converge on
    this QP, so x agrees to 1e-7 of its size."""
    arrs, q = _tiny()
    A = _t(arrs[1])
    if precision == "df32":
        A = T.split_f32(A)
    d = T.QPData(_t(arrs[0]), A, *map(_t, arrs[2:]))
    q = _t(q)
    fac = T.qp_setup(d, q_ref=q)
    st = T.qp_cold_state(fac, d)
    kw = dict(eps_abs=1e-9, eps_rel=1e-9, polish=True)
    st_m, x_m, _, _ = T.qp_solve_mixed(fac, d, q, st, max_iter=50,
                                       tail_iter=50, segment=50, **kw)
    plan = kernels.prepare(fac, mode="fused", precision=precision,
                           l_inv="off")
    st_f, x_f, _, _ = R.fused_mixed_solve(
        fac, plan.A_lo, d, q, st, bulk_iter=50, tail_iter=50,
        check_every=25, eps_abs=1e-9, eps_rel=1e-9, eps_abs_dua=1e-9,
        eps_rel_dua=1e-9, polish=True, polish_iters=12, polish_chunk=0,
        stall_rel=0.0, ir_sweeps=1, l_inv=False)
    np.testing.assert_allclose(x_f.numpy(), x_m.numpy(), atol=1e-10)
    np.testing.assert_allclose(st_f.pri_rel.numpy(), st_m.pri_rel.numpy(),
                               atol=1e-10)
    assert st_f.iters == st_m.iters
    if precision == "mixed":
        dj = J.QPData(*map(jnp.asarray, arrs))
        qj = jnp.asarray(q.numpy())
        fj = J.qp_setup(dj, q_ref=qj)
        _, x_j, _, _ = J.qp_solve_mixed(fj, dj, qj, J.qp_cold_state(fj, dj),
                                        max_iter=50, tail_iter=50,
                                        segment=50, **kw)
        assert _rel(x_j, x_m) < 1e-7


def test_df32_solve_matches_f64():
    """A df32 escalated solve (f32 bulk on A.hi, split tail) reaches the
    f64 solution's grade (tests/test_precision.py:208): pri_rel below
    5e-4, the objective within 3e-2 of the f64 solve's, a valid
    certified dual bound; the JAX package's df32 solve of the same QP
    meets the same bars."""
    d64, q64, f64f = _native_qp()
    st, x_ref, _, _ = T.qp_solve_segmented(
        f64f, d64, q64, T.qp_cold_state(f64f, d64), max_iter=6000,
        segment=1000, eps_abs=1e-8, eps_rel=1e-8)
    obj_ref = (q64 * x_ref).sum(-1) + 0.5 * (d64.P_diag * x_ref ** 2).sum(-1)
    (dj, qj, fj), (dp, qp, fp) = _split_qps()
    kw = dict(max_iter=1500, tail_iter=3000, eps_abs=1e-7, eps_rel=1e-7)
    stp, x_df, yA, yB = T.qp_solve_mixed(fp, dp, qp,
                                         T.qp_cold_state(fp, dp), **kw)
    stj, x_j, _, _ = J.qp_solve_mixed(fj, dj, qj, J.qp_cold_state(fj, dj),
                                      **kw)
    for pri, x in ((stp.pri_rel, x_df), (np.asarray(stj.pri_rel), _t(x_j))):
        assert float(np.max(np.asarray(pri))) < 5e-4
        obj = (q64 * x).sum(-1) + 0.5 * (d64.P_diag * x ** 2).sum(-1)
        np.testing.assert_allclose(obj.numpy(), obj_ref.numpy(), rtol=3e-2)
    dual = T.qp_dual_objective(dp, qp, 0.0, yA, yB, x_witness=x_df)
    assert bool((dual <= obj_ref + 1e-4 * obj_ref.abs()).all())


def test_mixed_segment_lo_and_f64_rule():
    """A longer f32 segment (subproblem_segment_lo) keeps the grade the
    mixed escalation delivers (tests/test_precision.py:123: pri_rel
    below 1e-3) and the objective within 3e-2 of the default's
    (tests/test_precision.py:229's band); mixed and df32 refuse an f32
    engine (:143); segment_lo must be positive.

    The JAX test also holds x at 1e-3. That holds there only because the
    JAX package's bulk exits inside its first 250-step segment on this
    QP, so its two runs are one trajectory. The port's f32 bulk, which
    sums in another order, runs past it (1500 vs 1000 bulk steps), and
    a segment boundary resets the stall window and the rho-adaptation
    cadence: two trajectories, landing on different points of this
    degenerate LP's optimal face (x 8.8 % apart at equal grade)."""
    d, q, fac = _native_qp()
    kw = dict(max_iter=1500, tail_iter=1500, eps_abs=1e-6, eps_rel=1e-6,
              segment=250)
    objs = []
    for seg_lo in (None, 1500):
        st, x, _, _ = T.qp_solve_mixed(fac, d, q, T.qp_cold_state(fac, d),
                                       segment_lo=seg_lo, **kw)
        assert float(st.pri_rel.max()) < 1e-3
        objs.append(float(((q * x).sum(-1)
                           + 0.5 * (d.P_diag * x * x).sum(-1)).sum()))
    assert objs[1] == pytest.approx(objs[0], rel=3e-2)
    with pytest.raises(ValueError):
        T.qp_solve_mixed(fac, d, q, T.qp_cold_state(fac, d), segment_lo=0,
                         **kw)
    bp = build_batch(uc.scenario_creator, uc.make_tree(4),
                     creator_kwargs={"num_gens": 3, "num_hours": 6,
                                     "relax_integrality": True})
    for prec in ("mixed", "df32"):
        with pytest.raises(ValueError):
            PHBase(bp, {"subproblem_precision": prec}, dtype=torch.float32,
                   device="cpu")
