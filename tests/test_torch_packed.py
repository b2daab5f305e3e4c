"""The port's structure-packed matvecs (mpisppy_tpu_torch.ops.packed)
against the JAX package's on the same UC matrix, on the CPU, and the
bulk's f32 block storage.

Tolerances, each stated where it is checked:
 - skeleton: the same index arrays, exactly;
 - f64 packed apply against the dense product: tests/test_packed.py's
   rtol 1e-12, atol 1e-9;
 - split packed apply against the f64 dense product: tests/test_packed.py's
   2e-6 relative (the split's f32 accumulation floor);
 - port against JAX on the same split operands: 1e-6 of the result's
   size (each sums the same f32 products in its own order);
 - the gather-only apply is bit-reproducible across calls;
 - a planted fault (one packed value changed) reads at least 10x the
   2e-6 bar."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.ir.standard_form import lower as jax_lower
from mpisppy_tpu.models import uc as jax_uc
from mpisppy_tpu.ops import packed as JP
from mpisppy_tpu.ops.qp_solver import split_f32 as jax_split_f32
from mpisppy_tpu_torch.ir.standard_form import lower
from mpisppy_tpu_torch.models import uc
from mpisppy_tpu_torch.ops import kernels
from mpisppy_tpu_torch.ops import packed as P
from mpisppy_tpu_torch.ops import qp_solver as T
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_UC_A_KW = dict(num_gens=6, num_hours=12, relax_integrality=True,
                min_up_down=True, ramping=True)


def _uc_A():
    """tests/test_packed.py's matrix, lowered by the port."""
    sf = lower(uc.scenario_creator("scen0", **_UC_A_KW))
    return np.asarray(sf.A, np.float64)


def _structure(A):
    rows, cols = np.nonzero(A)
    return P.analyze_structure(rows, cols, *A.shape)


def _split_packed(A):
    st = _structure(A)
    sp = T.split_f32(torch.as_tensor(A))
    return sp, P.pack(st, sp.hi), P.pack(st, sp.lo)


def test_analyze_structure_matches_jax():
    """The same skeleton as the JAX package's analyzer on the JAX
    package's own lowering of the matrix, and tests/test_packed.py's
    structural facts (one component per generator, few global rows,
    packed bytes under the profitability bar)."""
    A = _uc_A()
    A_jax = np.asarray(jax_lower(jax_uc.scenario_creator(
        "scen0", **_UC_A_KW)).A, np.float64)
    np.testing.assert_array_equal(A, A_jax)
    st = _structure(A)
    rows, cols = np.nonzero(A_jax)
    sj = JP.analyze_structure(rows, cols, *A_jax.shape)
    for name in ("g_rows", "l_rows", "l_cols"):
        np.testing.assert_array_equal(getattr(st, name),
                                      np.asarray(getattr(sj, name)))
    m, n = A.shape
    assert st.l_rows.shape[0] == 6
    assert st.g_rows.shape[0] < 0.2 * m
    packed = st.l_rows.shape[0] * st.l_rows.shape[1] \
        * st.l_cols.shape[1] + st.g_rows.shape[0] * n
    assert packed < 0.35 * m * n


def test_unstructured_matrix_falls_back():
    """One giant component: no packing (tests/test_packed.py)."""
    rng = np.random.RandomState(2)
    m, n = 400, 300
    A = (rng.rand(m, n) < 0.2).astype(float)
    rows, cols = np.nonzero(A)
    assert P.analyze_structure(rows, cols, m, n) is None


def test_packed_apply_matches_dense():
    """f64 packed apply against the dense product: rtol 1e-12,
    atol 1e-9 (tests/test_packed.py:46)."""
    A = _uc_A()
    m, n = A.shape
    pk = P.pack(_structure(A), torch.as_tensor(A))
    rng = np.random.RandomState(0)
    x, y = rng.randn(3, n), rng.randn(3, m)
    np.testing.assert_allclose(
        P.pk_Ax(pk, torch.as_tensor(x), m).numpy(), x @ A.T,
        rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        P.pk_ATy(pk, torch.as_tensor(y), n).numpy(), y @ A,
        rtol=1e-12, atol=1e-9)


def _split_vec(v):
    vh = torch.as_tensor(v, dtype=torch.float32)
    return vh, (torch.as_tensor(v) - vh.double()).float()


@pytest.mark.parametrize("transpose", [False, True])
def test_packed_split_apply_matches_dense_and_jax(transpose):
    """The split packed apply against the f64 dense product at the
    split's floor (2e-6 relative, tests/test_packed.py:61), against the
    port's dense split apply and against the JAX package's packed split
    apply at 1e-6 of the result's size (f32 sums in another order), and
    bit-equal across two calls (gathers only, no scatter-add)."""
    A = _uc_A()
    m, n = A.shape
    sp, pk_hi, pk_lo = _split_packed(A)
    rng = np.random.RandomState(1)
    v = rng.randn(2, m if transpose else n)
    vh, vl = _split_vec(v)
    fn = P.pk_ATy_split if transpose else P.pk_Ax_split
    size = n if transpose else m
    got = fn(pk_hi, pk_lo, vh, vl, size)
    assert torch.equal(got, fn(pk_hi, pk_lo, vh, vl, size))
    exact = v @ A if transpose else v @ A.T
    bar = 2e-6 * np.abs(A).max()
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-6, atol=bar)
    dense = (T._ATy if transpose else T._Ax)(sp, torch.as_tensor(v))
    scale = float(np.abs(exact).max())
    assert float((got - dense).abs().max()) <= 1e-6 * scale
    st = JP.analyze_structure(*np.nonzero(A), m, n)
    sj = jax_split_f32(jnp.asarray(A))
    jfn = JP.pk_ATy_split if transpose else JP.pk_Ax_split
    ref = np.asarray(jfn(JP.pack(st, sj.hi), JP.pack(st, sj.lo),
                         jnp.asarray(vh.numpy()), jnp.asarray(vl.numpy()),
                         size))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * scale


def test_planted_fault_in_packed_values_is_seen():
    """One value of pk_hi changed by 1 % of |A|max: the packed split
    matvec then misses the dense split matvec by at least 10x the
    2e-6 bar."""
    A = _uc_A()
    m, n = A.shape
    sp, pk_hi, pk_lo = _split_packed(A)
    c, r, k = map(int, np.argwhere(pk_hi.l_vals.abs().numpy() > 0)[0])
    vals = pk_hi.l_vals.clone()
    vals[c, r, k] += 0.01 * float(np.abs(A).max())
    bad = pk_hi._replace(l_vals=vals)
    x = np.random.RandomState(4).randn(2, n)
    xh, xl = _split_vec(x)
    dense = T._Ax(sp, torch.as_tensor(x))
    bar = 2e-6 * float(dense.abs().max())
    ok = float((P.pk_Ax_split(pk_hi, pk_lo, xh, xl, m) - dense).abs().max())
    hit = float((P.pk_Ax_split(bad, pk_lo, xh, xl, m) - dense).abs().max())
    assert ok <= bar
    assert hit >= 10 * bar


def test_packed_solve_trajectory_matches_dense():
    """Same cold state, adaptation off: the packed and dense df32
    solves run the same ADMM recursion, so the iterates differ only by
    f32 summation order (tests/test_packed.py's bar: 1e-4 of the
    iterate's size after 200 iterations)."""
    A = _uc_A()
    m, n = A.shape
    st = _structure(A)
    rng = np.random.RandomState(3)
    S = 2
    q = torch.as_tensor(rng.rand(S, n) * 10.0)
    lo = torch.as_tensor(np.tile(np.where(rng.rand(m) < 0.5, 0.0, -1e3),
                                 (S, 1)))
    hi = torch.full((S, m), 1e3, dtype=torch.float64)
    lb = torch.zeros((S, n), dtype=torch.float64)
    ub = torch.full((S, n), 1e2, dtype=torch.float64)
    Pd = torch.full((n,), 1e-3, dtype=torch.float64)
    outs = {}
    for tag, struct in (("packed", st), ("dense", None)):
        sp = T.split_f32(torch.as_tensor(A))._replace(struct=struct)
        data = T.QPData(Pd, sp, lo, hi, lb, ub)
        fac = T.qp_setup(data, q_ref=q)
        assert (fac.A_s.pk_hi is not None) == (struct is not None)
        state = T.qp_cold_state(fac, data)
        _, x, _, _ = T.qp_solve(fac, data, q, state, max_iter=200,
                                adaptive_rho=False, polish=False)
        outs[tag] = x
    scale = float(outs["dense"].abs().max()) + 1.0
    assert float((outs["packed"] - outs["dense"]).abs().max()) \
        <= 1e-4 * scale


# ---------------- the bulk's block storage ----------------

@pytest.mark.parametrize("block_dtype", ["auto", "f32", "bf16"])
def test_block_dtype_option_f32_only(block_dtype):
    """subproblem_kernel_block_dtype takes the JAX package's values:
    "auto" and "f32" give a df32 plan whose bulk operand is the packed
    hi blocks in f32 storage; "bf16" (the JAX package's opt-in) is not
    ported and raises NotImplementedError naming ROADMAP.md."""
    import types

    from mpisppy_tpu_torch.core.ph import PHBase
    from mpisppy_tpu_torch.ir.batch import build_batch
    from mpisppy_tpu_torch.models import farmer
    opts = {"subproblem_precision": "df32",
            "subproblem_kernel_block_dtype": block_dtype}
    batch = build_batch(farmer.scenario_creator, farmer.make_tree(3))
    if block_dtype == "bf16":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            PHBase(batch, opts, device="cpu")
        return
    PHBase(batch, opts, device="cpu")
    A = _uc_A()
    sp, pk_hi, pk_lo = _split_packed(A)
    sm = sp._replace(struct=_structure(A), pk_hi=pk_hi, pk_lo=pk_lo)
    plan = kernels.prepare(types.SimpleNamespace(A_s=sm), mode="fused",
                           precision="df32", l_inv="off")
    assert isinstance(plan.A_lo, T.PackedMatrix)
    assert plan.A_lo.pk.l_vals.dtype == torch.float32
    assert plan.descriptor()["block_dtype"] == "f32"
