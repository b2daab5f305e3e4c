"""Batched dense ADMM QP/LP solver (OSQP-style) in PyTorch — the port of
mpisppy_tpu/ops/qp_solver.py.

Form:   min ½ xᵀ diag(P) x + qᵀx   s.t.  l ≤ A x ≤ u,  lb ≤ x ≤ ub.

``A`` is shared (m, n) when every scenario has the same matrix (UC: the
randomness sits in the rhs) or batched (S, m, n) (farmer: yields sit in
A). Variable boxes are a second, diagonal constraint block handled
natively in the splitting. The method is the reference's: Ruiz
equilibration, per-row rho with equality boost, OSQP's adaptive rho with
refactorization, the stall exit and the active-set polish with
certified-dual selection. The loop runs on the host in eager PyTorch;
each residual check reads the convergence flag back (one scalar per
``check_every`` iterations).

Solve operator: in f64 the factor carried in ``QPState.L`` is the
EXPLICIT inverse ``F = M⁻¹`` of the KKT matrix (one product per
x-update, and the operand of the hand-written ADMM block in
``ops/kernels``); in f32 it is the Cholesky factor, or an ``LInv``
pair (L⁻¹ with L). Cholesky and the triangular solves are
``torch.linalg``; the (n, n) product ``Aᵀ diag(ρ) A`` is
``torch.matmul``.

Scenario-axis mesh (``mesh_scope``): inside the scope of a sharded
engine the three checks that read the whole batch become one
all-reduce each, so every rank scales, adapts and exits as the
unsharded solve of all ranks' rows would: the shared cost scale (the
max of the scaled cost over scenarios), the shared equality pattern and
adaptive rho (the mean of the log ratio over scenarios), and the exit
test (every scenario converged or stalled). Without a scope nothing
changes.

Precisions: ``native`` iterates in the engine dtype; ``qp_solve_mixed``
runs an f32 bulk phase, then an accurate tail. A shared A may be a
``SplitMatrix`` (the df32 representation: hi + lo f32 pair, optionally
with a structure-packed matvec form, ops/packed.py), and the tail then
solves with the f32 factor under split-f32 iterative refinement
(``_m_solve_ir``). Every f32 product here must be a true f32 product:
``utils/runtime.pin_precision`` turns TF32 off.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch

from .. import obs


_MESH = contextvars.ContextVar("qp_mesh", default=None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Solves and setups in this scope (this thread) reduce their
    whole-batch checks over ``mesh``'s ranks (parallel/mesh.Mesh; None
    turns the reduction off, as a rank's purely local solve needs)."""
    tok = _MESH.set(mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _MESH.reset(tok)


def _global_max(t):
    m = _MESH.get()
    return t if m is None else m.all_max(t)


def _global_all(flag):
    """A device bool that holds on every row of every rank."""
    m = _MESH.get()
    return flag if m is None else m.all_min(flag.to(torch.uint8)).bool()


class QPData(NamedTuple):
    """Stacked problem data; leading axis S = scenarios. ``A`` and
    ``P_diag`` may be unbatched ((m, n) / (n,)) when shared."""
    P_diag: torch.Tensor   # (S, n) or (n,)
    A: torch.Tensor        # (S, m, n) or (m, n)
    l: torch.Tensor        # (S, m)
    u: torch.Tensor        # (S, m)
    lb: torch.Tensor       # (S, n)
    ub: torch.Tensor       # (S, n)


class QPFactors(NamedTuple):
    """Scaling and scaled matrices; batched (S, ...) or shared."""
    sigma: float           # host float (constant per factorization)
    D: torch.Tensor        # (S, n) | (n,) column equilibration
    E: torch.Tensor        # (S, m) | (m,) row equilibration
    Eb: torch.Tensor       # (S, n) | (n,) bound-row equilibration
    cost_scale: torch.Tensor  # (S,) | () objective scaling
    A_s: torch.Tensor      # (S, m, n) | (m, n) scaled A
    P_s: torch.Tensor      # (S, n) | (n,) scaled P diagonal
    rho_A: torch.Tensor    # (S, m) | (m,) relative per-row rho
    rho_b: torch.Tensor    # (S, n) | (n,) bound-row rho


class QPState(NamedTuple):
    """Warm-startable solver state; L and rho persist across solves."""
    x: torch.Tensor        # (S, n) scaled iterate
    yA: torch.Tensor       # (S, m) scaled row duals
    yB: torch.Tensor       # (S, n) scaled bound duals
    zA: torch.Tensor       # (S, m) scaled row slacks
    zB: torch.Tensor       # (S, n) scaled bound slacks
    L: torch.Tensor        # (S,n,n)|(n,n) KKT inverse (f64) / Cholesky (f32)
    rho_scale: torch.Tensor  # (S,) | () multiplier on the rho patterns
    iters: int             # ADMM iterations run by the last solve
    pri_res: torch.Tensor  # (S,) unscaled
    dua_res: torch.Tensor  # (S,) unscaled
    pri_rel: torch.Tensor  # (S,) pri_res / problem scale
    dua_rel: torch.Tensor  # (S,) dua_res / dual scale


class LInv(NamedTuple):
    """Explicit inverse of a shared Cholesky factor (``inv`` = L⁻¹)
    with the factor itself (``tri``): x = L⁻ᵀ(L⁻¹ b) is two products.
    The ADMM block accepts it as its second solve-operator variant."""
    inv: torch.Tensor
    tri: torch.Tensor

    @property
    def dtype(self):
        return self.inv.dtype

    @property
    def ndim(self):
        return self.inv.ndim


class SplitMatrix(NamedTuple):
    """Double-float ("df32") matrix: hi + lo ≈ the f64 matrix, both f32.

    The classic two-term split gets about twice the f32 mantissa from
    THREE ordinary f32 products:

        A @ x ≈ hi @ x_hi + lo @ x_hi + hi @ x_lo      (drop lo·lo)

    accumulated in f64 (vectors only). Input quantization drops from
    ~6e-8 to ~4e-15 relative; what remains is each product's f32
    accumulation noise (~1e-7 relative), the ADMM residual floor of
    the df32 tail. A TF32 product would land inside that floor and
    ruin the refinement, hence the precision pin.

    ``struct``/``pk_hi``/``pk_lo`` (optional): the structure-packed
    matvec form (ops/packed.py). ``struct`` is the host skeleton
    attached at ship time; setup gathers the SCALED hi/lo into
    ``pk_hi``/``pk_lo``, after which every _Ax/_ATy pass reads the
    packed operands. The dense pair stays for the factorization's
    (n, n) product."""
    hi: torch.Tensor
    lo: torch.Tensor
    struct: object = None      # packed.PackStructure | None
    pk_hi: object = None       # packed.Packed | None
    pk_lo: object = None       # packed.Packed | None

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        # the VALUE dtype the pair represents (consumers dispatch on it)
        return torch.float64

    @property
    def device(self):
        return self.hi.device


class PackedMatrix(NamedTuple):
    """Single-precision matrix with a packed matvec form riding along:
    the f32 bulk phase's view of a packed SplitMatrix (dense ``hi`` for
    in-loop refactorization, packed for every matvec)."""
    dense: torch.Tensor
    pk: object                 # packed.Packed

    @property
    def ndim(self):
        return self.dense.ndim

    @property
    def shape(self):
        return self.dense.shape

    @property
    def dtype(self):
        return self.dense.dtype

    @property
    def device(self):
        return self.dense.device


def split_f32(a) -> SplitMatrix:
    """Two-term split of an f64 tensor (hi = f32 round, lo = residual)."""
    hi = a.to(torch.float32)
    lo = (a - hi.to(torch.float64)).to(torch.float32)
    return SplitMatrix(hi, lo)


def split_f32_np(a):
    """Host-numpy twin of split_f32 (the one split convention: shipping
    and tests must not re-derive it). Returns (hi, lo)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def merged64(A):
    """The f64 value of a SplitMatrix (or a plain tensor cast to f64).
    Materializes (m, n) in f64: tests and small sizes only."""
    if isinstance(A, SplitMatrix):
        return A.hi.to(torch.float64) + A.lo.to(torch.float64)
    return A.to(torch.float64)


class ScaledView(NamedTuple):
    """QPData.A as a VIEW over the factors' scaled matrix:
    A = diag(1/E) · A_s · diag(1/D). At df32 scale the raw split A and
    the scaled split A_s would both be gigabytes; once the base factors
    exist, the engine swaps its QPData.A for this view and the raw pair
    frees. _Ax/_ATy (residual checks, dual objectives) dispatch on it."""
    A_s: object             # SplitMatrix or dense (m, n)
    D: torch.Tensor         # (n,)
    E: torch.Tensor         # (m,)

    @property
    def ndim(self):
        return 2

    @property
    def shape(self):
        return self.A_s.shape

    @property
    def dtype(self):
        return torch.float64

    @property
    def device(self):
        return self.D.device


def _split_vec(v):
    """(hi, lo) f32 split of an f64 vector batch."""
    vh = v.to(torch.float32)
    return vh, (v - vh.to(torch.float64)).to(torch.float32)


def _Ax(A, x):
    """A x with A (m, n) shared, (S, m, n) batched, SplitMatrix (three
    f32 products accumulated in f64), PackedMatrix or ScaledView;
    x (S, n) -> (S, m). Packed forms route through ops/packed.py."""
    if isinstance(A, ScaledView):
        return _Ax(A.A_s, x / A.D) / A.E
    if isinstance(A, PackedMatrix):
        from .packed import pk_Ax
        return pk_Ax(A.pk, x, A.dense.shape[0])
    if isinstance(A, SplitMatrix):
        xh, xl = _split_vec(x)
        if A.pk_hi is not None:
            from .packed import pk_Ax_split
            return pk_Ax_split(A.pk_hi, A.pk_lo, xh, xl, A.hi.shape[0])
        f64 = torch.float64
        return ((xh @ A.hi.T).to(f64) + (xh @ A.lo.T).to(f64)
                + (xl @ A.hi.T).to(f64))
    if A.ndim == 2:
        return x @ A.T
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def host_dense_A(A):
    """Host numpy f64 of a QPData.A under any representation. A
    ScaledView at df32 scale would need a multi-GB device-to-host pull:
    consumers must use the device paths (_Ax, _ATy, support_touch)."""
    import numpy as np
    if isinstance(A, ScaledView):
        raise TypeError("host_dense_A on a ScaledView: reconstructing "
                        "the dense matrix host-side defeats the view's "
                        "purpose; use _Ax/_ATy/support_touch on device")
    if isinstance(A, SplitMatrix):
        return merged64(A).cpu().numpy()
    return A.detach().to(torch.float64).cpu().numpy()


def support_touch(A, viol):
    """(S, n) column-touch counts of the (S, m) bool row mask ``viol``
    through A's sparsity support, on A's device (the dive's targeted
    repair column selection)."""
    hi = A
    if isinstance(A, ScaledView):
        hi = A.A_s
    if isinstance(hi, SplitMatrix):
        hi = hi.hi
    supp = (hi.abs() > 1e-10).to(torch.float32)
    v = torch.as_tensor(viol, device=hi.device).to(torch.float32)
    if hi.ndim == 2:
        return v @ supp
    return torch.einsum("sm,smn->sn", v, supp)


def _ATy(A, y):
    """Aᵀ y with A in any of _Ax's representations; y (S, m) -> (S, n)."""
    if isinstance(A, ScaledView):
        return _ATy(A.A_s, y / A.E) / A.D
    if isinstance(A, PackedMatrix):
        from .packed import pk_ATy
        return pk_ATy(A.pk, y, A.dense.shape[1])
    if isinstance(A, SplitMatrix):
        yh, yl = _split_vec(y)
        if A.pk_hi is not None:
            from .packed import pk_ATy_split
            return pk_ATy_split(A.pk_hi, A.pk_lo, yh, yl, A.hi.shape[1])
        f64 = torch.float64
        return ((yh @ A.hi).to(f64) + (yh @ A.lo).to(f64)
                + (yl @ A.hi).to(f64))
    if A.ndim == 2:
        return y @ A
    return torch.bmm(A.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)


def _ruiz_equilibrate(P_diag, A, iters=15):
    """Modified Ruiz equilibration of the KKT matrix [[P, Āᵀ],[Ā, 0]]
    with Ā = [A; I]; the bound-row block enters analytically (its
    scaled row j is the single value g_j = Eb_j·D_j). Returns (D, E, Eb)
    with scaled P = D P D, A = E A D, bound rows = diag(Eb·D).

    Works on |A| once: the scalings are positive, so |E·A·D| equals
    E·|A|·D exactly, and one (m, n) transient serves every sweep."""
    n = A.shape[-1]
    m = A.shape[-2]
    bshape = A.shape[:-2]
    kw = dict(dtype=A.dtype, device=A.device)
    D = torch.ones(bshape + (n,), **kw)
    E = torch.ones(bshape + (m,), **kw)
    Eb = torch.ones(bshape + (n,), **kw)
    absA = A.abs()
    for _ in range(iters):
        As = E.unsqueeze(-1) * absA * D.unsqueeze(-2)
        colmax = As.amax(dim=-2)
        rnorm = As.amax(dim=-1)
        del As
        Ps = D * P_diag * D
        g = Eb * D
        cnorm = torch.maximum(torch.maximum(Ps.abs(), colmax), g.abs())
        d = torch.where(cnorm < 1e-12, 1.0,
                        1.0 / torch.sqrt(torch.clamp(cnorm, min=1e-12)))
        e = torch.where(rnorm < 1e-12, 1.0,
                        1.0 / torch.sqrt(torch.clamp(rnorm, min=1e-12)))
        eb = 1.0 / torch.sqrt(torch.clamp(g.abs(), min=1e-12))
        D, E, Eb = D * d, E * e, Eb * eb
    return D, E, Eb


def _symmetrized(M):
    """(M + Mᵀ)/2, in place: the products that build a KKT matrix are
    symmetric only up to roundoff, and the factorization reads the
    symmetrized matrix (as jnp.linalg.cholesky does by default)."""
    Mt = M.transpose(-2, -1).clone()
    return M.add_(Mt).mul_(0.5)


def _factorize(factors: QPFactors, rho_scale):
    """EXPLICIT INVERSE of M = diag(P_s) + σI + A_sᵀ diag(ρ_A) A_s
    + diag(g²ρ_b) in f64 (the Cholesky factor in f32, where an
    inverse's κ(M)·eps error would destabilize the iteration). Shared
    mode returns one (n, n) operator, batched mode (S, n, n). The
    inverse is built from the Cholesky factor by two triangular solves
    against the identity."""
    if isinstance(factors.A_s, SplitMatrix):
        return _factorize_split(factors, rho_scale)
    A_s, P_s = factors.A_s, factors.P_s
    if isinstance(A_s, PackedMatrix):
        # in-loop refactorization in the f32 bulk: the packed form serves
        # the matvecs, the (n, n) product reads the dense hi
        A_s = A_s.dense
    g = factors.Eb * factors.D
    n = A_s.shape[-1]
    invert = A_s.dtype == torch.float64
    if A_s.ndim == 2:
        rA = factors.rho_A * rho_scale
        rB = factors.rho_b * rho_scale
        M = A_s.T @ (rA.unsqueeze(-1) * A_s)
        M.diagonal().add_(P_s + factors.sigma + g * g * rB)
    else:
        rA = factors.rho_A * rho_scale.unsqueeze(-1)
        rB = factors.rho_b * rho_scale.unsqueeze(-1)
        M = (A_s * rA.unsqueeze(-1)).transpose(1, 2) @ A_s
        diag = M.diagonal(dim1=-2, dim2=-1)
        diag.add_(factors.sigma)
        diag.add_(P_s + g * g * rB)
    L = torch.linalg.cholesky(_symmetrized(M))
    del M
    if not invert:
        return L
    eye = torch.eye(n, dtype=A_s.dtype, device=A_s.device).expand(L.shape)
    w = torch.linalg.solve_triangular(L, eye, upper=False)
    del eye
    # the kernel layer reads F row-major: return it contiguous
    return torch.linalg.solve_triangular(L.transpose(-2, -1), w,
                                         upper=True).contiguous()


def _factorize_split(factors: QPFactors, rho_scale):
    """df32 factorization: a plain f32 Cholesky factor of M from ONE f32
    product of the hi part, no f64 matmul. The factor is a
    PRECONDITIONER: the df32 x-update (_m_solve_ir) wraps each solve in
    mixed-precision iterative refinement whose residuals come from
    split-f32 matvecs, which corrects both M's f32 quantization and the
    κ(M)·eps32 solve error."""
    A_s, P_s = factors.A_s, factors.P_s
    f32 = torch.float32
    g32 = (factors.Eb * factors.D).to(f32)
    rA32 = (factors.rho_A * rho_scale).to(f32)
    rB32 = (factors.rho_b * rho_scale).to(f32)
    M32 = A_s.hi.T @ (rA32.unsqueeze(-1) * A_s.hi)
    M32.diagonal().add_(P_s.to(f32) + factors.sigma + g32 * g32 * rB32)
    return torch.linalg.cholesky(_symmetrized(M32))


def _device_f64_linalg_trusted():
    """CUDA and CPU execute f64 Cholesky and triangular solves natively
    (the JAX package's TPU distrust does not apply to this port)."""
    return True


def _needs_host_factor(factors) -> bool:
    """Whether a factorization must run on the host: never on the
    port's devices (kept for the option surface the engine shares)."""
    return factors.A_s.ndim == 3 and factors.A_s.dtype == torch.float64 \
        and not _device_f64_linalg_trusted()


def _tri_solve(L, b):
    """Solve M x = b from a Cholesky factor L; b (S, n). The polish's
    penalty systems use it (too ill-conditioned for an inverse)."""
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-2, -1), y, upper=True)
    return x.squeeze(-1)


def _chol_solve(F, b):
    """Solve M x = b with _factorize's output: the explicit f64 inverse
    (one product; M⁻¹ is symmetric), an LInv pair (two products), or an
    f32 Cholesky factor (triangular solves)."""
    if isinstance(F, LInv):
        out_dt = b.dtype
        u = b.to(F.inv.dtype) @ F.inv.T
        return (u @ F.inv).to(out_dt)
    if F.dtype == torch.float64:
        if F.ndim == 2:
            return b @ F
        return torch.bmm(F, b.unsqueeze(-1)).squeeze(-1)
    out_dt = b.dtype
    b = b.to(F.dtype)
    if F.ndim == 2:
        y = torch.linalg.solve_triangular(F, b.T, upper=False)
        x = torch.linalg.solve_triangular(F.T, y, upper=True)
        return x.T.to(out_dt)
    return _tri_solve(F, b).to(out_dt)


def _is_eq(lo, hi):
    d_ = hi - lo
    return torch.isfinite(d_) & (d_.abs() <= 1e-9 * (1.0 + hi.abs()))


def _rho_patterns(l, u, lb, ub, rho_base, eq_boost, shared, dt):
    """Equality-boosted rho patterns: a row must be an equality in every
    scenario to earn the shared boost (rho is only a stepsize, so the
    conservative AND is safe)."""
    is_eq = _is_eq(l, u)
    is_eq_b = _is_eq(lb, ub)
    if shared:
        is_eq = _global_all(is_eq.all(dim=0))
        is_eq_b = _global_all(is_eq_b.all(dim=0))
    kw = dict(dtype=dt, device=l.device)
    hi = torch.tensor(rho_base * eq_boost, **kw)
    lo = torch.tensor(rho_base, **kw)
    return torch.where(is_eq, hi, lo), torch.where(is_eq_b, hi, lo)


def _setup_vectors(P_diag, l, u, lb, ub, D, q_ref, rho_base, eq_boost,
                   shared, dt):
    """Everything in qp_setup after the scaled matrix exists: the cost
    normalization (OSQP sec 5.1: objective gradient O(1)) and the
    equality-boosted rho patterns. Returns (P_s, cost_scale, rho_A,
    rho_b)."""
    P_s = D * P_diag * D
    if q_ref is None:
        q_ref = torch.zeros(lb.shape, dtype=dt, device=lb.device)
    qs = D * q_ref
    gn_P = P_s.abs().amax(dim=-1)
    gn_q = qs.abs().amax(dim=-1)
    if shared:
        gnorm = torch.maximum(gn_P, _global_max(gn_q.amax()))
        cost_scale = 1.0 / torch.clamp(gnorm, min=1.0)
        P_s = P_s * cost_scale
    else:
        gnorm = torch.maximum(gn_P, gn_q)
        cost_scale = 1.0 / torch.clamp(gnorm, min=1.0)
        P_s = P_s * cost_scale.unsqueeze(-1)
    rho_A, rho_b = _rho_patterns(l, u, lb, ub, rho_base, eq_boost,
                                 shared, dt)
    return P_s, cost_scale, rho_A, rho_b


def _scale_split_blocks(A: SplitMatrix, D, E, nblocks=8) -> SplitMatrix:
    """A_s = split(E·A·D) in ROW BLOCKS, so the f64 value of the scaled
    matrix only exists one block at a time."""
    m = A.hi.shape[0]
    his, los = [], []
    bounds = [(m * i) // nblocks for i in range(nblocks + 1)]
    f64 = torch.float64
    for i in range(nblocks):
        sl = slice(bounds[i], bounds[i + 1])
        blk = (A.hi[sl].to(f64) + A.lo[sl].to(f64)) \
            * E[sl].unsqueeze(-1) * D.unsqueeze(0)
        hi = blk.to(torch.float32)
        los.append((blk - hi.to(f64)).to(torch.float32))
        his.append(hi)
        del blk
    return SplitMatrix(torch.cat(his), torch.cat(los))


def _qp_setup_split(data: QPData, q_ref, rho_base, sigma, eq_boost):
    """df32 setup: Ruiz on the f32 hi part (the scalings are heuristic:
    a 1e-7-relative view of |A| changes nothing), the scaled split built
    blockwise, its packed form gathered when the shipped matrix carries
    a structure, and the vector tail shared with the dense path."""
    A = data.A
    f64 = torch.float64
    D32, E32, Eb32 = _ruiz_equilibrate(data.P_diag.to(torch.float32), A.hi)
    D, E, Eb = D32.to(f64), E32.to(f64), Eb32.to(f64)
    A_s = _scale_split_blocks(A, D, E)
    if A.struct is not None:
        # the same index skeleton serves hi and lo (scaling preserves
        # structure); from here every hot-loop A-pass is packed
        from .packed import pack
        A_s = A_s._replace(struct=A.struct, pk_hi=pack(A.struct, A_s.hi),
                           pk_lo=pack(A.struct, A_s.lo))
    P_s, cost_scale, rho_A, rho_b = _setup_vectors(
        data.P_diag, data.l, data.u, data.lb, data.ub, D, q_ref, rho_base,
        eq_boost, True, f64)
    return QPFactors(sigma=float(sigma), D=D, E=E, Eb=Eb,
                     cost_scale=cost_scale, A_s=A_s, P_s=P_s,
                     rho_A=rho_A, rho_b=rho_b)


def qp_setup(data: QPData, q_ref=None, rho_base=0.1, sigma=1e-6,
             eq_boost=1e3) -> QPFactors:
    """Equilibrate and scale. Re-solves with a new q reuse everything;
    the equality-row rho boost depends only on which rows/columns are
    pinned (l == u / lb == ub), so one setup serves every PH iteration
    of a mode. A SplitMatrix A takes the df32 setup."""
    if isinstance(data.A, SplitMatrix):
        return _qp_setup_split(data, q_ref, rho_base, sigma, eq_boost)
    P_diag, A, l, u, lb, ub = data
    D, E, Eb = _ruiz_equilibrate(P_diag, A)
    A_s = E.unsqueeze(-1) * A * D.unsqueeze(-2)
    P_s, cost_scale, rho_A, rho_b = _setup_vectors(
        P_diag, l, u, lb, ub, D, q_ref, rho_base, eq_boost, A.ndim == 2,
        A.dtype)
    return QPFactors(sigma=float(sigma), D=D, E=E, Eb=Eb,
                     cost_scale=cost_scale, A_s=A_s, P_s=P_s,
                     rho_A=rho_A, rho_b=rho_b)


def qp_setup_like(base: QPFactors, data: QPData, rho_base=0.1,
                  eq_boost=1e3) -> QPFactors:
    """Factors for a related mode (prox on/off, pinned boxes) reusing
    ``base``'s equilibration and scaled matrix: only the scaled
    quadratic diagonal and the rho patterns are recomputed. In df32
    every mode shares the one scaled split this way."""
    shared = base.A_s.ndim == 2
    csx = base.cost_scale if shared else base.cost_scale.unsqueeze(-1)
    P_s = base.D * data.P_diag * base.D * csx
    rho_A, rho_b = _rho_patterns(data.l, data.u, data.lb, data.ub,
                                 rho_base, eq_boost, shared, base.D.dtype)
    return base._replace(P_s=P_s, rho_A=rho_A, rho_b=rho_b)


def qp_reset_rho(factors: QPFactors, state: QPState) -> QPState:
    """Reset the adaptive-rho trajectory (rho_scale back to 1 with the
    matching refactorization); iterates are kept."""
    ones = torch.ones_like(state.rho_scale)
    return state._replace(rho_scale=ones, L=_factorize(factors, ones))


def qp_cold_state(factors: QPFactors, data: QPData) -> QPState:
    """Zero iterates, infinite residuals and the factor at rho_scale 1."""
    S, m = data.l.shape
    n = data.lb.shape[-1]
    kw = dict(dtype=factors.A_s.dtype, device=factors.A_s.device)
    shared = factors.A_s.ndim == 2
    rho_scale = torch.ones((), **kw) if shared else torch.ones((S,), **kw)
    inf = torch.full((S,), math.inf, **kw)
    return QPState(x=torch.zeros((S, n), **kw),
                   yA=torch.zeros((S, m), **kw),
                   yB=torch.zeros((S, n), **kw),
                   zA=torch.zeros((S, m), **kw),
                   zB=torch.zeros((S, n), **kw),
                   L=_factorize(factors, rho_scale), rho_scale=rho_scale,
                   iters=0, pri_res=inf, dua_res=inf.clone(),
                   pri_rel=inf.clone(), dua_rel=inf.clone())


def _scaled_problem(factors: QPFactors, data: QPData, q):
    """The scaled problem vectors one solve iterates in:
    (g, l_s, u_s, lb_s, ub_s, csx, q_s). Shared by _solve_impl and the
    ADMM block's driver so both iterate the same problem."""
    D, E, Eb, cs, A_s = (factors.D, factors.E, factors.Eb,
                         factors.cost_scale, factors.A_s)
    shared = A_s.ndim == 2
    g = Eb * D
    l_s, u_s = E * data.l, E * data.u
    lb_s, ub_s = Eb * data.lb, Eb * data.ub
    csx = cs if shared else cs.unsqueeze(-1)
    q_s = csx * D * q
    return g, l_s, u_s, lb_s, ub_s, csx, q_s


def _amax_abs(a):
    return a.abs().amax(dim=1)


def stacked_residuals(states, field="pri_rel"):
    """One device-side stack of per-chunk residual vectors ->
    (n_chunks, chunk). The chunked PH gate reads every chunk's
    residuals each iteration; stacking on the device first means the
    caller pays ONE device-to-host copy per iteration instead of one
    blocking read per chunk."""
    return torch.stack([getattr(s, field) for s in states])


def _unscaled_residuals(A_s, P_s, g, D, E, Eb, csx, q_s, x, yA, yB, zA,
                        zB):
    """UNSCALED residuals (OSQP's default termination convention) and
    their scales: (pri, dua, pri_sc, dua_sc), each (S,)."""
    Ax = _Ax(A_s, x)
    Aty = _ATy(A_s, yA)
    Einv = 1.0 / E
    Ebinv = 1.0 / Eb
    Dinv_c = 1.0 / (D * csx)
    pri = torch.maximum(_amax_abs(Einv * (Ax - zA)),
                        _amax_abs(D * x - Ebinv * zB))
    dua = _amax_abs(Dinv_c * (P_s * x + q_s + Aty + g * yB))
    pri_sc = torch.clamp(torch.maximum(
        torch.maximum(_amax_abs(Einv * Ax), _amax_abs(Einv * zA)),
        torch.maximum(_amax_abs(D * x), _amax_abs(Ebinv * zB))), min=1e-6)
    dua_sc = torch.clamp(torch.maximum(
        torch.maximum(_amax_abs(Dinv_c * P_s * x), _amax_abs(Dinv_c * q_s)),
        torch.maximum(_amax_abs(Dinv_c * Aty),
                      _amax_abs(Dinv_c * g * yB))), min=1e-6)
    return pri, dua, pri_sc, dua_sc


def make_l_inv(L) -> LInv:
    """L -> (L⁻¹, L): one n-RHS triangular solve. The explicit L⁻¹ is
    licensed only under iterative refinement (the df32 tail); solves
    with no refinement around them use ``tri``."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return LInv(torch.linalg.solve_triangular(L, eye,
                                              upper=False).contiguous(), L)



def _refactor_like(factors, rho_scale, like):
    """In-loop refactorization that keeps the carried container: a
    state running the L⁻¹ x-update gets a fresh L⁻¹."""
    L_new = _factorize(factors, rho_scale)
    if isinstance(like, LInv):
        return make_l_inv(L_new)
    return L_new


def _solve_impl(factors: QPFactors, data: QPData, q, state: QPState,
                max_iter=4000, check_every=25, eps_abs=1e-6, eps_rel=1e-6,
                alpha=1.6, adaptive_rho=True, polish=True, polish_iters=12,
                polish_chunk=0, eps_abs_dua=None, eps_rel_dua=None,
                stall_rel=0.0, ir_sweeps=1):
    """The solve: relaxed ADMM in ``check_every``-step chunks with
    residual checks, OSQP rho adaptation every 4th check (refactorize
    when the ideal rho moved more than 5x; one shared scalar in shared
    mode), the window-based stall exit (off when ``stall_rel`` is 0),
    then the active-set polish (chunked over scenarios by
    ``polish_chunk``) that picks the best-KKT point and the duals with
    the best certified dual objective.

    With a SplitMatrix A_s (df32) the x-update is the f32 factor under
    ``ir_sweeps`` sweeps of split-f32 iterative refinement
    (_m_solve_ir), and the polish is off: its per-scenario (n, n)
    penalty factors are what the representation exists to avoid, and
    the ADMM duals still give a valid bound through qp_dual_objective.

    Returns (state, x (S,n), yA (S,m), yB (S,n)): state iterates scaled,
    the returned solution and duals UNscaled."""
    sigma, D, E, Eb, cs, A_s, P_s, rho_A, rho_b = factors
    shared = A_s.ndim == 2
    split_mode = isinstance(A_s, SplitMatrix)
    if split_mode:
        polish = False
    g, l_s, u_s, lb_s, ub_s, csx, q_s = _scaled_problem(factors, data, q)
    eps_abs_dua = eps_abs if eps_abs_dua is None else eps_abs_dua
    eps_rel_dua = eps_rel if eps_rel_dua is None else eps_rel_dua

    def rho_of(rho_scale):
        rs = rho_scale if shared else rho_scale.unsqueeze(-1)
        return rho_A * rs, rho_b * rs

    def _m_solve_ir(L, rhs, rA, rB):
        """df32 x-update: f32 solves + ``ir_sweeps`` sweeps of
        mixed-precision iterative refinement. The residual rhs − Mx goes
        through the SPLIT matvecs (f64 accumulation of f32 products), so
        each sweep contracts the error by ~κ(M)·eps32; M is applied in
        factored form (P, σ, A_sᵀρA_s, bound rows), never stored. One
        sweep lands at ~(κ·eps32)², below the split's own ~1e-7 floor."""
        def m_apply(v):
            return P_s * v + sigma * v + _ATy(A_s, rA * _Ax(A_s, v)) \
                + g * g * rB * v

        x = _chol_solve(L, rhs)
        for _ in range(ir_sweeps):
            x = x + _chol_solve(L, rhs - m_apply(x))
        return x

    def admm_chunk(x, yA, yB, zA, zB, L, rA, rB):
        # un-refined solves must not use an explicit L⁻¹ (see LInv): an
        # LInv carry hands its raw factor to them
        Lop = L.tri if isinstance(L, LInv) and not split_mode else L
        for _ in range(check_every):
            rhs = sigma * x - q_s + _ATy(A_s, rA * zA - yA) \
                + g * (rB * zB - yB)
            x_t = _m_solve_ir(Lop, rhs, rA, rB) if split_mode \
                else _chol_solve(Lop, rhs)
            x_new = alpha * x_t + (1 - alpha) * x
            zA_t = _Ax(A_s, x_t)
            zA_mix = alpha * zA_t + (1 - alpha) * zA
            zA_new = torch.clamp(zA_mix + yA / rA, l_s, u_s)
            yA = yA + rA * (zA_mix - zA_new)
            zB_t = g * x_t
            zB_mix = alpha * zB_t + (1 - alpha) * zB
            zB_new = torch.clamp(zB_mix + yB / rB, lb_s, ub_s)
            yB = yB + rB * (zB_mix - zB_new)
            x, zA, zB = x_new, zA_new, zB_new
        return x, yA, yB, zA, zB

    def residuals(x, yA, yB, zA, zB):
        return _unscaled_residuals(A_s, P_s, g, D, E, Eb, csx, q_s,
                                   x, yA, yB, zA, zB)

    x, yA, yB, zA, zB = state.x, state.yA, state.yB, state.zA, state.zB
    L, rho_scale = state.L, state.rho_scale
    S_ = data.l.shape[0]
    dkw = dict(dtype=A_s.dtype, device=A_s.device)
    best_pri = torch.full((S_,), math.inf, **dkw)
    best_dua = torch.full((S_,), math.inf, **dkw)
    stall_ct = torch.zeros((S_,), dtype=torch.int32, device=A_s.device)
    it, done = 0, False
    while it < max_iter and not done:
        rA, rB = rho_of(rho_scale)
        x, yA, yB, zA, zB = admm_chunk(x, yA, yB, zA, zB, L, rA, rB)
        pri, dua, pri_sc, dua_sc = residuals(x, yA, yB, zA, zB)
        conv_ok = (pri <= eps_abs + eps_rel * pri_sc) \
            & (dua <= eps_abs_dua + eps_rel_dua * dua_sc)
        if stall_rel:
            improved = (pri <= 0.95 * best_pri) | (dua <= 0.95 * best_dua)
            best_pri = torch.minimum(best_pri, pri)
            best_dua = torch.minimum(best_dua, dua)
        rho_changed = torch.zeros_like(conv_ok)
        if adaptive_rho and ((it // check_every) % 4) == 3:
            not_conv = ~_global_all(conv_ok.all())
            ratio_s = torch.sqrt((pri / pri_sc)
                                 / torch.clamp(dua / dua_sc, min=1e-30))
            if shared:
                logs = torch.log(torch.clamp(ratio_s, 1e-6, 1e6))
                mesh = _MESH.get()
                if mesh is None:
                    ratio = torch.exp(torch.mean(logs))
                else:
                    tot = mesh.all_sum(torch.stack(
                        [logs.sum(), torch.tensor(
                            float(logs.numel()), dtype=logs.dtype,
                            device=logs.device)]))
                    ratio = torch.exp(tot[0] / tot[1])
                new_scale = torch.clamp(rho_scale * ratio, 1e-6, 1e6)
                change = torch.maximum(new_scale / rho_scale,
                                       rho_scale / new_scale)
                upd = (change > 5.0) & not_conv
                rho_scale = torch.where(upd, new_scale, rho_scale)
                need = upd
                rho_changed = upd.expand(conv_ok.shape)
            else:
                new_scale = torch.clamp(rho_scale * ratio_s, 1e-6, 1e6)
                change = torch.maximum(new_scale / rho_scale,
                                       rho_scale / new_scale)
                mask = (change > 5.0) & not_conv
                rho_scale = torch.where(mask, new_scale, rho_scale)
                need = mask.any()
                rho_changed = mask
            if bool(need):
                L = _refactor_like(factors, rho_scale, L)
        if stall_rel:
            stall_ct = torch.where(improved | rho_changed,
                                   torch.zeros_like(stall_ct), stall_ct + 1)
            stalled = (stall_ct >= 4) & (pri <= stall_rel * pri_sc)
        else:
            stalled = torch.zeros_like(conv_ok)
        done = bool(_global_all((conv_ok | stalled).all()))
        it += check_every

    pri, dua, pri_sc, dua_sc = residuals(x, yA, yB, zA, zB)
    # the ADMM iterates are what the next solve warm-starts from
    new_state = QPState(x=x, yA=yA, yB=yB, zA=zA, zB=zB, L=L,
                        rho_scale=rho_scale, iters=it,
                        pri_res=pri, dua_res=dua, pri_rel=pri / pri_sc,
                        dua_rel=dua / dua_sc)
    if not polish:
        return new_state, D * x, (E / csx) * yA, (Eb / csx) * yB

    S = data.l.shape[0]
    step = polish_chunk if polish_chunk and 0 < polish_chunk < S else S
    outs = []
    for lo in range(0, S, step):
        sl = slice(lo, min(lo + step, S))
        if shared:
            A_l, P_l, D_l, E_l, Eb_l, cs_l = A_s, P_s, D, E, Eb, cs
            d_l = QPData(data.P_diag, data.A, data.l[sl], data.u[sl],
                         data.lb[sl], data.ub[sl])
        else:
            A_l, P_l, D_l, E_l, Eb_l, cs_l = (A_s[sl], P_s[sl], D[sl],
                                              E[sl], Eb[sl], cs[sl])
            d_l = QPData(data.P_diag[sl], data.A[sl], data.l[sl],
                         data.u[sl], data.lb[sl], data.ub[sl])
        csx_l = cs_l if shared else cs_l.unsqueeze(-1)
        outs.append(_polish_select(
            A_l, P_l, Eb_l * D_l, D_l, E_l, Eb_l, csx_l, sigma, d_l,
            q[sl], q_s[sl], l_s[sl], u_s[sl], lb_s[sl], ub_s[sl],
            x[sl], yA[sl], yB[sl], zA[sl], zB[sl],
            pri[sl], dua[sl], pri_sc[sl], dua_sc[sl], polish_iters,
            eps_abs, eps_rel))
    x_un, yA_un, yB_un, pri, dua, pri_sc = (
        torch.cat(parts) for parts in zip(*outs))
    # dua_rel keeps the pre-polish dual scale (the polish returns none)
    new_state = new_state._replace(pri_res=pri, dua_res=dua,
                                   pri_rel=pri / pri_sc)
    return new_state, x_un, yA_un, yB_un


def _penalty_kkt(A, rpA, P, g, rpB, sigma):
    """Per-scenario penalty KKT M_p = P + σI + Aᵀdiag(rpA)A + diag(g²rpB),
    (S, n, n). Only the rows a scenario penalizes enter its product, so
    a shared A is never broadcast to (S, m, n)."""
    S = rpA.shape[0]
    n = A.shape[-1]
    Mp = torch.empty((S, n, n), dtype=A.dtype, device=A.device)
    for s in range(S):
        A_sc = A if A.ndim == 2 else A[s]
        rows = torch.nonzero(rpA[s]).squeeze(-1)
        A_k = A_sc.index_select(0, rows)
        torch.matmul(A_k.T, rpA[s, rows].unsqueeze(-1) * A_k, out=Mp[s])
        del A_k
    P_b = P.expand(S, n) if P.ndim == 1 else P
    Mp.diagonal(dim1=-2, dim2=-1).add_(P_b + sigma + g * g * rpB)
    return Mp


# whether the dual-candidate selection may lean on the primal witness
# (see cut_dual_selection)
_SELECT_WITH_WITNESS = contextvars.ContextVar("select_with_witness",
                                              default=True)


@contextlib.contextmanager
def cut_dual_selection():
    """Within this context (per thread), the polish keeps the dual
    candidate with the best certified objective WITHOUT the witness
    fallback: the deepest Benders cut at the solve's pinned point. The
    default selection lets the witness rescue a candidate whose free
    column keeps a surviving reduced cost on an infinite bound, which
    certifies a bound at this solve but gives a -inf cut, since a cut
    must hold at every point (benders_cut). The L-shaped cut solves run
    in this context."""
    token = _SELECT_WITH_WITNESS.set(False)
    try:
        yield
    finally:
        _SELECT_WITH_WITNESS.reset(token)


def _polish_select(A_s, P_s, g, D, E, Eb, csx, sigma, data, q, q_s,
                   l_s, u_s, lb_s, ub_s, x, yA, yB, zA, zB,
                   pri, dua, pri_sc, dua_sc, polish_iters,
                   eps_abs=1e-6, eps_rel=1e-6):
    """Active-set polish (OSQP sec 5.2, batched) + dual-candidate
    selection, as in the JAX package: (1) proximal AL on the
    slack-detected active set, (2) the same after dropping wrong-sign
    rows, (3) a sign-projected AL. x/pri/dua are the best-KKT point
    among {ADMM, 1, 2}; the duals are the per-scenario argmax of the
    certified dual objective over {ADMM, 1, 2, 3}."""
    rho_big = torch.tensor(1e5, dtype=x.dtype, device=x.device)
    S = x.shape[0]
    P_b = P_s.expand(S, P_s.shape[-1]) if P_s.ndim == 1 else P_s

    def residuals(x_, yA_, yB_, zA_, zB_):
        return _unscaled_residuals(A_s, P_s, g, D, E, Eb, csx, q_s,
                                   x_, yA_, yB_, zA_, zB_)

    act_tol = torch.clamp(10.0 * (pri / pri_sc), min=1e-5).unsqueeze(-1)

    def act(lo, hi, zv):
        a_l = torch.isfinite(lo) & (zv - lo <= act_tol * (1.0 + lo.abs()))
        a_u = torch.isfinite(hi) & (hi - zv <= act_tol * (1.0 + hi.abs()))
        hi0 = torch.where(torch.isfinite(hi), hi, 0.0)
        lo0 = torch.where(torch.isfinite(lo), lo, 0.0)
        b = torch.where(a_u, hi0, torch.where(a_l, lo0, 0.0))
        return a_l | a_u, b

    def penalty_factor(actA, actB):
        rpA = torch.where(actA, rho_big, 0.0)
        rpB = torch.where(actB, rho_big, 0.0)
        Lp = torch.linalg.cholesky(
            _symmetrized(_penalty_kkt(A_s, rpA, P_s, g, rpB, sigma)))

        def apply_Mp(v):
            return P_b * v + sigma * v \
                + _ATy(A_s, rpA * _Ax(A_s, v)) + g * g * rpB * v

        return rpA, rpB, Lp, apply_Mp

    def polish_round(actA, bA, actB, bB, x0):
        """Proximal AL on the guessed active set, duals from zero, two
        refinement sweeps per inner solve."""
        rpA, rpB, Lp, apply_Mp = penalty_factor(actA, actB)
        x_p, yA_p, yB_p = x0, torch.zeros_like(yA), torch.zeros_like(yB)
        for _ in range(polish_iters):
            rhs = sigma * x_p - q_s + _ATy(A_s, rpA * bA - yA_p) \
                + g * (rpB * bB - yB_p)
            x_n = _tri_solve(Lp, rhs)
            x_n = x_n + _tri_solve(Lp, rhs - apply_Mp(x_n))
            x_n = x_n + _tri_solve(Lp, rhs - apply_Mp(x_n))
            yA_p = yA_p + rpA * (_Ax(A_s, x_n) - bA)
            yB_p = yB_p + rpB * (g * x_n - bB)
            x_p = x_n
        return x_p, yA_p, yB_p

    def sign_projected_round(alA, auA, eqA, bA, alB, auB, eqB, bB, x0,
                             iters):
        """AL with per-iteration dual sign projection: a safe dual
        candidate under degeneracy."""
        rpA, rpB, Lp, apply_Mp = penalty_factor(alA | auA, alB | auB)

        def clampy(y, al, au, eq):
            y = torch.where(au & ~eq, torch.clamp(y, min=0.0), y)
            y = torch.where(al & ~eq, torch.clamp(y, max=0.0), y)
            return torch.where(al | au, y, 0.0)

        x_p, yA_p, yB_p = x0, torch.zeros_like(yA), torch.zeros_like(yB)
        for _ in range(iters):
            rhs = sigma * x_p - q_s + _ATy(A_s, rpA * bA - yA_p) \
                + g * (rpB * bB - yB_p)
            x_n = _tri_solve(Lp, rhs)
            x_n = x_n + _tri_solve(Lp, rhs - apply_Mp(x_n))
            yA_p = clampy(yA_p + rpA * (_Ax(A_s, x_n) - bA), alA, auA, eqA)
            yB_p = clampy(yB_p + rpB * (g * x_n - bB), alB, auB, eqB)
            x_p = x_n
        return x_p, yA_p, yB_p

    def accept(x, yA, yB, pri, dua, pri_sc, dua_sc, x_p, yA_p, yB_p):
        zA_p = torch.clamp(_Ax(A_s, x_p), l_s, u_s)
        zB_p = torch.clamp(g * x_p, lb_s, ub_s)
        pri_p, dua_p, pri_sc_p, dua_sc_p = residuals(x_p, yA_p, yB_p,
                                                     zA_p, zB_p)
        score = torch.maximum(pri / pri_sc, dua / dua_sc)
        score_p = torch.maximum(pri_p / pri_sc_p, dua_p / dua_sc_p)
        # a candidate may trade primal for dual accuracy only inside the
        # requested primal tolerance band
        band = torch.maximum(pri, eps_abs + eps_rel * pri_sc)
        ok = (score_p < score) & (pri_p <= band)
        okc = ok.unsqueeze(-1)
        return (torch.where(okc, x_p, x), torch.where(okc, yA_p, yA),
                torch.where(okc, yB_p, yB),
                torch.where(ok, pri_p, pri), torch.where(ok, dua_p, dua),
                torch.where(ok, pri_sc_p, pri_sc),
                torch.where(ok, dua_sc_p, dua_sc))

    # round 1: active set from the ADMM slacks
    actA, bA = act(l_s, u_s, zA)
    actB, bB = act(lb_s, ub_s, zB)
    x_p, yA_p, yB_p = polish_round(actA, bA, actB, bB, x)
    cand1 = (yA_p, yB_p)
    x, yA, yB, pri, dua, pri_sc, dua_sc = accept(
        x, yA, yB, pri, dua, pri_sc, dua_sc, x_p, yA_p, yB_p)

    # round 2: re-detect at the polished point, drop wrong-sign rows
    def refilter(lo, hi, zv, yv):
        a, b = act(lo, hi, zv)
        eq = torch.isfinite(hi - lo) & ((hi - lo).abs()
                                        <= 1e-9 * (1.0 + hi.abs()))
        at_u = a & (b == torch.where(torch.isfinite(hi), hi, 0.0)) \
            & (zv >= hi - act_tol * (1.0 + hi.abs()))
        wrong = torch.where(at_u, yv < 0.0, yv > 0.0) & ~eq
        return a & ~wrong, b

    zA_p = torch.clamp(_Ax(A_s, x_p), l_s, u_s)
    zB_p = torch.clamp(g * x_p, lb_s, ub_s)
    actA2, bA2 = refilter(l_s, u_s, zA_p, yA_p)
    actB2, bB2 = refilter(lb_s, ub_s, zB_p, yB_p)
    x_p2, yA_p2, yB_p2 = polish_round(actA2, bA2, actB2, bB2, x_p)
    cand2 = (yA_p2, yB_p2)
    x, yA, yB, pri, dua, pri_sc, dua_sc = accept(
        x, yA, yB, pri, dua, pri_sc, dua_sc, x_p2, yA_p2, yB_p2)

    # round 3: sign-projected candidate
    def act2(lo, hi, zv):
        a_l = torch.isfinite(lo) & (zv - lo <= act_tol * (1.0 + lo.abs()))
        a_u = torch.isfinite(hi) & (hi - zv <= act_tol * (1.0 + hi.abs()))
        return a_l, a_u, a_l & a_u

    alA, auA, eqA = act2(l_s, u_s, zA)
    alB, auB, eqB = act2(lb_s, ub_s, zB)
    _, yA_p3, yB_p3 = sign_projected_round(
        alA, auA, eqA, bA, alB, auB, eqB, bB, x, 3 * polish_iters)
    cand3 = (yA_p3, yB_p3)

    def unscale_y(yA_, yB_):
        return (E / csx) * yA_, (Eb / csx) * yB_

    x_un = D * x
    yA_un, yB_un = unscale_y(yA, yB)
    # keep the dual pair with the best certified dual objective; NaN
    # candidates never poison best_val
    x_wit = x_un if _SELECT_WITH_WITNESS.get() else None
    best_val = qp_dual_objective(data, q, 0.0, yA_un, yB_un, x_witness=x_wit)
    best_val = torch.where(torch.isnan(best_val), -math.inf, best_val)
    for yA_c, yB_c in (cand1, cand2, cand3):
        yA_cu, yB_cu = unscale_y(yA_c, yB_c)
        val = qp_dual_objective(data, q, 0.0, yA_cu, yB_cu, x_witness=x_wit)
        better = val > best_val
        yA_un = torch.where(better.unsqueeze(-1), yA_cu, yA_un)
        yB_un = torch.where(better.unsqueeze(-1), yB_cu, yB_un)
        best_val = torch.where(better, val, best_val)
    return x_un, yA_un, yB_un, pri, dua, pri_sc


def qp_solve(factors: QPFactors, data: QPData, q, state: QPState, **kw):
    """One solve (see _solve_impl for the algorithm and options)."""
    obs.counter_add("qp.solve_segments")
    if obs.enabled():
        # the measured roofline (obs/profile.py): booked after the call
        # from the iteration count the solve read to decide its exit
        from ..obs import profile as _profile
        return _profile.call(
            "qp.solve", lambda: _solve_impl(factors, data, q, state, **kw),
            lambda out: solve_work(factors, data, out[0],
                                   kw.get("check_every", 25),
                                   kw.get("ir_sweeps", 1)),
            device=state.x.device)
    return _solve_impl(factors, data, q, state, **kw)


def solve_work(factors: QPFactors, data: QPData, state: QPState,
               check_every, ir_sweeps=1):
    """(shape key, flops, bytes) of a finished solve of ``state.iters``
    ADMM steps (obs/profile.qp_cost): the shapes, the steps and the
    check cadence, not the code that ran them. A df32 (SplitMatrix)
    solve refines each x-update ``ir_sweeps`` times."""
    from ..obs.profile import qp_cost
    A_s = factors.A_s
    S, n = state.x.shape
    m = data.l.shape[-1]
    shared = A_s.ndim == 2
    split = isinstance(A_s, SplitMatrix)
    r = int(ir_sweeps) if split else 0
    f_mats = 2 if split and isinstance(state.L, LInv) else 1
    it = int(state.iters)
    flops, nbytes = qp_cost(S, m, n, it, check_every, shared=shared,
                            f_mats=f_mats, ir_sweeps=r,
                            itemsize=state.x.element_size())
    return (S, m, n, it, int(check_every), shared, f_mats, r,
            str(state.x.dtype)), flops, nbytes


def qp_solve_segmented(factors: QPFactors, data: QPData, q, state: QPState,
                       max_iter=4000, segment=500, **kw):
    """Warm-started SEGMENTS of at most ``segment`` iterations (polish
    deferred to one final call) until convergence/stall or
    ``max_iter`` — the JAX package's host-segmented driver, kept for
    its semantics: segments run full, so the total can overshoot
    ``max_iter`` by up to one segment."""
    final_polish = kw.pop("polish", True)
    total = 0
    while total < max_iter:
        state, _, _, _ = qp_solve(factors, data, q, state,
                                  max_iter=segment, polish=False, **kw)
        ran = state.iters
        total += ran
        if ran < segment:   # early exit: converged or stalled
            break
    state, x, yA, yB = qp_solve(factors, data, q, state, max_iter=0,
                                polish=final_polish, **kw)
    return state._replace(iters=total), x, yA, yB


def _cast_floats(tree, dt):
    """Cast the floating tensor fields of a QPFactors/QPData/QPState
    (an LInv field included) to ``dt``; everything else rides along.
    Split and packed containers are left as they are: they are f32
    storage already."""
    def cast(v):
        if isinstance(v, LInv):
            return LInv(cast(v.inv), cast(v.tri))
        if isinstance(v, torch.Tensor) and v.is_floating_point() \
                and v.dtype != dt:
            return v.to(dt)
        return v

    return tree._replace(**{k: cast(v) for k, v in zip(tree._fields, tree)})


def _lo_eps(eps_abs, eps_rel, eps_rel_dua):
    """The f32 bulk's termination floors: the bulk is a WARM START for
    the tail, so it stops at its noise floor (1e-4 absolute, 1e-3
    relative; a coarse 1e-2 on the dual, which plateaus well above the
    primal in f32)."""
    return (max(float(eps_abs), 1e-4), max(float(eps_rel), 1e-3),
            max(float(eps_rel if eps_rel_dua is None else eps_rel_dua),
                1e-2))


def _solve_lo_impl(f_lo, d_lo, q_lo, st_lo, max_iter, check_every, eps_abs,
                   eps_rel, alpha, adaptive_rho, polish_iters, eps_rel_dua,
                   stall_rel):
    """One polish-free f32 segment of the mixed drivers."""
    st_lo, _, _, _ = _solve_impl(f_lo, d_lo, q_lo, st_lo, max_iter,
                                 check_every, eps_abs, eps_rel, alpha,
                                 adaptive_rho, False, polish_iters, 0,
                                 eps_abs, eps_rel_dua, stall_rel)
    return st_lo


def bulk_operand(A_s):
    """The f32 bulk phase's A: the plain hi part of a SplitMatrix (one
    product per matvec, not three), with its packed view when present;
    any other A as it is (the bulk casts it)."""
    if isinstance(A_s, SplitMatrix):
        if A_s.pk_hi is not None:
            return PackedMatrix(A_s.hi, A_s.pk_hi)
        return A_s.hi
    return A_s


def qp_solve_mixed(factors: QPFactors, data: QPData, q, state: QPState,
                   max_iter=4000, tail_iter=1000, check_every=25,
                   eps_abs=1e-6, eps_rel=1e-6, alpha=1.6, adaptive_rho=True,
                   polish=True, polish_iters=12, polish_chunk=0,
                   eps_abs_dua=None, eps_rel_dua=None, stall_rel=0.0,
                   segment=500, segment_lo=None, ir_sweeps=1):
    """Precision-escalated solve, host-segmented: an f32 bulk phase
    (segments of ``segment_lo``, default ``segment``, iterations until
    its noise-floor test passes or ``max_iter``), then the accurate tail
    (qp_solve_segmented with ``tail_iter``) and the polish.

    Everything arrives in f64; the f32 copies are cast here. In df32
    (SplitMatrix factors) the bulk iterates on the hi part (packed when
    available) with the state's own f32 factor, and the tail reuses the
    factor the bulk ended on: the factor is a pure function of the
    adapted rho. Otherwise the bulk factors its f32 copy and the tail
    refactors in f64 at the handed-over rho. ``max_iter`` bounds the
    bulk only; total work can reach max_iter + tail_iter plus one
    segment of overshoot each. Returns (state, x, yA, yB) with the
    state in f64."""
    lo = torch.float32
    split = isinstance(factors.A_s, SplitMatrix)
    f_lo = _cast_floats(factors._replace(A_s=bulk_operand(factors.A_s)), lo)
    # the bulk never polishes, so its data's A is never read
    d_lo = _cast_floats(data._replace(A=f_lo.A_s), lo)
    st_lo = _cast_floats(state, lo)
    if not split:
        st_lo = st_lo._replace(L=_factorize(f_lo, st_lo.rho_scale))
    eps_lo, eps_rel_lo, eps_rel_lo_dua = _lo_eps(eps_abs, eps_rel,
                                                 eps_rel_dua)
    if segment_lo is not None and int(segment_lo) <= 0:
        raise ValueError("segment_lo must be positive (None = use "
                         "`segment` for both phases)")
    seg_lo = segment if segment_lo is None else int(segment_lo)
    q_lo = q.to(lo)
    lo_total = 0
    while lo_total < max_iter:
        obs.counter_add("qp.solve_segments")

        def seg(st_lo=st_lo):
            return _solve_lo_impl(f_lo, d_lo, q_lo, st_lo, seg_lo,
                                  check_every, eps_lo, eps_rel_lo, alpha,
                                  adaptive_rho, polish_iters,
                                  eps_rel_lo_dua, stall_rel)
        if obs.enabled():
            from ..obs import profile as _profile
            st_lo = _profile.call(
                "qp.solve_lo", seg,
                lambda out: solve_work(f_lo, d_lo, out, check_every, 0),
                device=st_lo.x.device)
        else:
            st_lo = seg()
        ran = st_lo.iters
        lo_total += ran
        if ran < seg_lo:
            break
    dt_hi = state.x.dtype
    rho_hi = st_lo.rho_scale.to(dt_hi)
    L_hi = st_lo.L if split else _factorize(factors, rho_hi)
    st_hi = _cast_floats(st_lo._replace(L=None), dt_hi)._replace(
        L=L_hi, rho_scale=rho_hi)
    st_hi, x, yA, yB = qp_solve_segmented(
        factors, data, q, st_hi, max_iter=tail_iter, segment=segment,
        check_every=check_every, eps_abs=eps_abs, eps_rel=eps_rel,
        alpha=alpha, adaptive_rho=adaptive_rho, polish=polish,
        polish_iters=polish_iters, polish_chunk=polish_chunk,
        eps_abs_dua=eps_abs_dua, eps_rel_dua=eps_rel_dua,
        stall_rel=stall_rel, ir_sweeps=ir_sweeps)
    return st_hi._replace(iters=lo_total + st_hi.iters), x, yA, yB


def qp_objective(data: QPData, q, c0, x):
    """½x'Px + q'x + c0 per scenario (unscaled)."""
    return 0.5 * torch.sum(data.P_diag * x * x, dim=-1) \
        + torch.sum(q * x, dim=-1) + c0


def qp_state_duals(factors: QPFactors, state: QPState):
    """UNSCALED (yA, yB) dual iterates of a warm solver state."""
    cs = factors.cost_scale
    csx = cs if factors.A_s.ndim == 2 else cs.unsqueeze(-1)
    return (factors.E / csx) * state.yA, (factors.Eb / csx) * state.yB


def _sanitize_row_duals(lo, hi, y):
    """Zero dual components that push on an infinite bound."""
    y = torch.where(torch.isposinf(hi) & (y > 0), 0.0, y)
    return torch.where(torch.isneginf(lo) & (y < 0), 0.0, y)


def qp_repair_duals(l, u, lb, ub, yA, yB):
    """Project unscaled duals onto the dual-feasible cone (zero every
    component pushing on an infinite bound)."""
    return (_sanitize_row_duals(l, u, yA), _sanitize_row_duals(lb, ub, yB))


def _boxmin(P, r, lb, ub):
    """Coordinate-wise min of ½P x² + r x over [lb, ub] (P >= 0);
    -inf where a linear piece descends toward an infinite bound."""
    pos = P > 0
    x_unc = torch.where(pos, -r / torch.where(pos, P, 1.0), 0.0)
    x_star = torch.minimum(torch.maximum(x_unc, lb), ub)
    quad_val = 0.5 * P * x_star * x_star + r * x_star
    lin_lo = torch.where(r > 0, torch.where(torch.isneginf(lb), -math.inf,
                                            r * lb), 0.0)
    lin_hi = torch.where(r < 0, torch.where(torch.isposinf(ub), -math.inf,
                                            r * ub), 0.0)
    return torch.where(pos, quad_val, lin_lo + lin_hi)


def _sup_rows(l, u, y, inf_tol=1e-9):
    """sup over the row box of y'z: u'y+ − l'y−, +inf when a positive
    dual pushes on an infinite bound."""
    yp = torch.clamp(y, min=0.0)
    ym = torch.clamp(-y, min=0.0)
    u_fin = torch.where(torch.isfinite(u), u, 0.0)
    l_fin = torch.where(torch.isfinite(l), l, 0.0)
    inf_hit = (torch.isposinf(u) & (yp > inf_tol)) \
        | (torch.isneginf(l) & (ym > inf_tol))
    return torch.sum(u_fin * yp - l_fin * ym, dim=-1) \
        + torch.sum(torch.where(inf_hit, math.inf, 0.0 * yp), dim=-1)


def _column_bound(P, q, r, y_b, lb, ub, x_witness, r_rel_tol):
    """Per-column contribution to the dual bound: best of keeping or
    dropping the bound-row dual, plus the witness fallback where both
    are -inf."""
    tol = r_rel_tol * torch.clamp(q.abs(), min=1.0)
    r_a = torch.where(r.abs() <= tol, 0.0, r)
    ybp = torch.clamp(y_b, min=0.0)
    ybm = torch.clamp(-y_b, min=0.0)
    ub_fin = torch.where(torch.isfinite(ub), ub, 0.0)
    lb_fin = torch.where(torch.isfinite(lb), lb, 0.0)
    sup_b = ub_fin * ybp - lb_fin * ybm \
        + torch.where((torch.isposinf(ub) & (ybp > 1e-9))
                      | (torch.isneginf(lb) & (ybm > 1e-9)), math.inf,
                      0.0 * ybp)
    contrib_a = _boxmin(P, r_a, lb, ub) - sup_b
    contrib_b = _boxmin(P, r - y_b, lb, ub)
    best = torch.maximum(contrib_a, contrib_b)
    if x_witness is not None:
        def clamped(rv):
            r_fix = torch.where(torch.isposinf(ub) & (rv < 0), 0.0, rv)
            r_fix = torch.where(torch.isneginf(lb) & (r_fix > 0), 0.0,
                                r_fix)
            penalty = (rv - r_fix).abs() * (2.0 * x_witness.abs() + 1.0)
            return _boxmin(P, r_fix, lb, ub) - penalty

        fallback = torch.maximum(clamped(r_a) - sup_b, clamped(r - y_b))
        best = torch.maximum(best, torch.where(torch.isneginf(best),
                                               fallback, best))
    return best


def qp_dual_objective(data: QPData, q, c0, yA, yB, x_witness=None,
                      r_rel_tol=1e-6):
    """Per-scenario LOWER bound on min ½x'Px + q'x + c0 s.t. the rows and
    boxes, from (approximately) dual-feasible (yA, yB) — the Lagrangian
    dual evaluated per coordinate as in the JAX package (see its
    docstring for the derivation)."""
    yA = _sanitize_row_duals(data.l, data.u, yA)
    yB = _sanitize_row_duals(data.lb, data.ub, yB)
    r = q + _ATy(data.A, yA) + yB
    best = _column_bound(data.P_diag, q, r, yB, data.lb, data.ub,
                         x_witness, r_rel_tol)
    sup_c = _sup_rows(data.l, data.u, yA)
    return torch.sum(best, dim=-1) - sup_c + c0


def benders_cut(data: QPData, q, c0, yA, yB, param_mask, b0,
                r_rel_tol=1e-6):
    """Affine minorant of the value function V(b) = min ½x'Px + q'x + c0
    s.t. l <= Ax <= u and the boxes, with the columns in ``param_mask``
    fixed at b (their boxes carry lb = ub = b in ``data``): the
    L-shaped optimality cut, from (possibly inexact) ADMM duals.

    Returns (const (S,), g (S, n) zero outside ``param_mask``) with
    V(b) >= const + g·b for every b, up to the r_rel_tol
    residual-zeroing convention. Dropping the bound dual on the
    parameter columns leaves the dual function affine in b there, with
    the quadratic linearised at ``b0`` (a convex function's tangent is
    a global minorant); the free columns contribute the per-coordinate
    terms of qp_dual_objective without the witness fallback (its box is
    tied to the solve at b0, and a cut must hold at every b: a -inf
    free column gives an inactive -inf cut)."""
    pm = param_mask
    P = data.P_diag
    yA = _sanitize_row_duals(data.l, data.u, yA)
    yB = _sanitize_row_duals(data.lb, data.ub, yB)
    r = q + _ATy(data.A, yA) + yB
    r_c = r - yB     # the residual without the bound dual
    g = torch.where(pm, r_c + P * b0, 0.0)
    const_param = torch.sum(torch.where(pm, -0.5 * P * b0 * b0, 0.0),
                            dim=-1)
    best = _column_bound(P, q, r, yB, data.lb, data.ub, None, r_rel_tol)
    const_free = torch.sum(torch.where(pm, 0.0, best), dim=-1)
    sup_c = _sup_rows(data.l, data.u, yA)
    return const_param + const_free - sup_c + c0, g
