"""The port's fused ADMM block (mpisppy_tpu_torch.ops.kernels.admm_block)
and kernel layer against the JAX package's Pallas block, run as the JAX
package's own tests run it on the CPU (interpret=True). On the CPU the
port's wrapper runs the block's plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.ops import kernels as jax_kernels
from mpisppy_tpu.ops import qp_solver as J
from mpisppy_tpu.ops.kernels import pallas_kernel
from mpisppy_tpu_torch import obs
from mpisppy_tpu_torch.ops import kernels
from mpisppy_tpu_torch.ops import qp_solver as T
from mpisppy_tpu_torch.ops.kernels import admm_block
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


def _both(S=3, seed=2, l_inv=False, dtype=torch.float64):
    data, q = _tiny_arrays(S=S, seed=seed)
    dj = J.QPData(*map(jnp.asarray, data))
    dt = T.QPData(*(torch.as_tensor(np.asarray(a), dtype=dtype)
                    for a in data))
    qj, qt = jnp.asarray(q), torch.as_tensor(q, dtype=dtype)
    fj, ft = J.qp_setup(dj, q_ref=qj), T.qp_setup(dt, q_ref=qt)
    sj, st = J.qp_cold_state(fj, dj), T.qp_cold_state(ft, dt)
    if l_inv:
        # the same L⁻¹ pair for both packages, built in numpy from the
        # JAX factors' KKT matrix at rho_scale 1
        A_s, P_s = np.asarray(fj.A_s), np.asarray(fj.P_s)
        g = np.asarray(fj.Eb * fj.D)
        M = A_s.T @ (np.asarray(fj.rho_A)[:, None] * A_s) + np.diag(
            P_s + float(fj.sigma) + g * g * np.asarray(fj.rho_b))
        Lc = np.linalg.cholesky(M)
        Li = np.linalg.inv(Lc)
        sj = sj._replace(L=J.LInv(jnp.asarray(Li), jnp.asarray(Lc)))
        st = st._replace(L=T.LInv(torch.as_tensor(Li), torch.as_tensor(Lc)))
    return (fj, dj, qj, sj), (ft, dt, qt, st)


@pytest.mark.parametrize("l_inv", [False, True])
@pytest.mark.parametrize("tile", [0, 2])
def test_block_matches_pallas_interpret(l_inv, tile):
    """20 steps: scaled iterates and residual maxima at atol 1e-9 (the
    bar of tests/test_kernels.py:357-376), for both solve operators,
    untiled and with 2-row scenario tiles."""
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(S=4, l_inv=l_inv)
    assert pallas_kernel.pallas_supported(fj, sj)
    assert admm_block.scope_supported(ft, st)
    ref = pallas_kernel.fused_admm_block(fj, dj, qj, sj, n_steps=20,
                                         interpret=True, scen_tile=tile)
    got = admm_block.fused_admm_block(ft, dt, qt, st, n_steps=20,
                                      scen_tile=tile)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-9)


def test_tiled_equals_untiled():
    _, (ft, dt, qt, st) = _both(S=4)
    a = admm_block.fused_admm_block(ft, dt, qt, st, n_steps=20,
                                    scen_tile=0)
    b = admm_block.fused_admm_block(ft, dt, qt, st, n_steps=20,
                                    scen_tile=2)
    for u, v in zip(a, b):
        # CPU BLAS may block a 2-row product differently from a 4-row
        # one: f64 roundoff, not a semantic difference
        np.testing.assert_allclose(v.numpy(), u.numpy(), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("m,n", [(26016, 13056), (300, 200), (301, 199),
                                 (1000, 600), (6, 4)])
def test_tile_schedule_depends_on_shape_only(m, n):
    """The kernel's split of each product (which fixes its order of
    summation) is the same for S = 1, 10 and 256 scenario rows, so a
    scenario-tiled call sums as an untiled one does; every part of a
    split is non-empty and within the scratch bound."""
    plans = [admm_block.launch_plan(S, m, n, l_inv)
             for S in (1, 10, 256) for l_inv in (False, True)]
    for plan in plans[1:]:
        assert plan["schedule"] == plans[0]["schedule"]
        assert plan["sched_ints"] == plans[0]["sched_ints"]
    stages = admm_block._stages(m, n)
    for key, (parts, per) in plans[0]["schedule"].items():
        assert 1 <= parts <= admm_block.MAX_SPLIT
        assert (parts - 1) * per < stages[key][1] <= parts * per
    # only the scratch follows S
    assert plans[2]["part"] == 10 * plans[0]["part"]
    assert plans[4]["part"] == 256 * plans[0]["part"]


def test_block_matches_reference_solver():
    """The block iterates the problem _solve_impl iterates: 20 fixed-rho
    steps agree with qp_solve's (adaptive_rho off, one check)."""
    _, (ft, dt, qt, st) = _both()
    x, yA, yB, zA, zB, pri, dua = admm_block.fused_admm_block(
        ft, dt, qt, st, n_steps=20)
    st_r, _, _, _ = T.qp_solve(ft, dt, qt, st, max_iter=20,
                               check_every=20, eps_abs=0.0, eps_rel=0.0,
                               polish=False, adaptive_rho=False)
    for a, b in ((x, st_r.x), (zA, st_r.zA), (pri, st_r.pri_res),
                 (dua, st_r.dua_res)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("backend", ["cuda", "pallas"])
def test_kernel_solve_matches_jax(backend):
    (fj, dj, qj, sj), (ft, dt, qt, st) = _both(seed=4)
    kw = dict(precision="native", max_iter=400, tail_iter=0, e_pri=1e-8,
              e_dua=1e-8, stall_rel=0.0, polish=True, polish_chunk=0,
              ir_sweeps=1)
    pj = jax_kernels.prepare(fj, mode="fused", backend="pallas",
                             precision="native")
    pt = kernels.prepare(ft, mode="fused", backend=backend,
                         precision="native")
    assert pt.backend == "cuda" and pj.backend == "pallas"
    rj = jax_kernels.kernel_solve(pj, fj, dj, qj, sj, **kw)
    rt = kernels.kernel_solve(pt, ft, dt, qt, st, **kw)
    assert rt[0].iters == int(rj[0].iters) == 400
    assert float(rt[0].pri_rel.max()) < 1e-6
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(rt[0].x.numpy(), np.asarray(rj[0].x),
                               rtol=0, atol=1e-8)


def test_out_of_scope_operator_demotes_with_event():
    """An f32 Cholesky factor is not an f64 explicit inverse: the cached
    plan demotes to the reference backend and books the event."""
    _, (ft, dt, qt, st) = _both(dtype=torch.float32)
    plan = kernels.prepare(ft, mode="fused", backend="cuda",
                           precision="native")
    assert plan.backend == "cuda"
    assert not admm_block.scope_supported(ft, st)
    obs.configure()
    try:
        before = admm_block.LAUNCHES
        st2, x, _, _ = kernels.kernel_solve(
            plan, ft, dt, qt, st, precision="native", max_iter=200,
            tail_iter=0, e_pri=1e-5, e_dua=1e-5, stall_rel=0.0,
            polish=False, polish_chunk=0, ir_sweeps=1)
        assert plan.backend == "reference"
        assert len(obs.events("kernel.cuda_demotion")) == 1
        assert admm_block.LAUNCHES == before
        assert torch.all(torch.isfinite(x))
    finally:
        obs.shutdown()


def test_prepare_scope_and_unported_precisions():
    """Batched A is outside the block's scope (reference backend). The
    df32/mixed precisions, ported since, never take the block either: on
    a shared 2-D A, plain or split, their plan runs the reference
    backend's fused mixed solve with the bulk operand staged (as in the
    JAX package, whose Pallas block needs native precision)."""
    rng = np.random.default_rng(1)
    S, m, n = 2, 3, 4
    data = T.QPData(torch.ones(S, n), torch.as_tensor(rng.normal(
        size=(S, m, n))), -torch.ones(S, m), torch.ones(S, m),
        -torch.ones(S, n), torch.ones(S, n))
    fac = T.qp_setup(data)
    assert kernels.prepare(fac, mode="fused", backend="cuda").backend \
        == "reference"
    assert kernels.prepare(fac, mode="segmented").mode == "segmented"
    A2 = torch.as_tensor(rng.normal(size=(m, n)))
    for A in (A2, T.split_f32(A2)):
        f2 = T.qp_setup(data._replace(P_diag=torch.ones(n), A=A))
        for prec in ("mixed", "df32"):
            plan = kernels.prepare(f2, mode="fused", backend="cuda",
                                   precision=prec)
            assert plan.backend == "reference" and plan.mode == "fused"
            bulk = f2.A_s.hi if isinstance(A, T.SplitMatrix) else f2.A_s
            assert plan.A_lo is bulk


def test_block_refuses_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other non-CUDA
    device raises instead of running it."""
    ops = {k: torch.empty(1, device="meta")
           for k in admm_block._IN + admm_block._ITER}
    with pytest.raises(ValueError, match="no kernel"):
        admm_block._block(ops, 1e-6, 1, 1.6, False)
