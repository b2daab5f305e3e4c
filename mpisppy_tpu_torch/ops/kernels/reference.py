"""The fused precision-escalated solve (the port of
mpisppy_tpu/ops/kernels/reference.py): one call runs the f32 bulk
phase, hands the factor over and runs the accurate tail, with no host
read between the phases. The math is qp_solve_mixed's; what the fusion
removes is the segment loop (and its per-segment iteration readbacks)
and the phase-boundary casts of separate calls.

The JAX package's ``l_inv`` trade rides here, unchanged: the df32
tail's two triangular solves become two products of the same bytes by
carrying the explicit L⁻¹ (qp_solver.LInv), behind
``l_inv_profitable``. It is no kernel of its own: the products are
torch operations. (The JAX package's other trade, bf16 packed blocks
for the bulk, is not ported: the bulk's blocks are f32.)
"""

from __future__ import annotations

import torch

from ... import obs
from ..qp_solver import (LInv, PackedMatrix, SplitMatrix,
                         _cast_floats, _factorize, _lo_eps, make_l_inv,
                         _solve_impl)

__all__ = ["fused_mixed_solve", "l_inv_profitable"]


# ---------------- trade guards ----------------

def l_inv_profitable(n, s_chunk, tail_iter, ir_sweeps=1):
    """Whether the explicit L⁻¹ build amortizes: the inverse
    back-substitutes n RHS columns once; only the TAIL applies it
    (``s_chunk`` columns ``1 + ir_sweeps`` times per iteration), so the
    test is one tail's column solves >= n. The df32 chunk chain flows
    one factor across chunks and warm-started PH iterations until rho
    refactorizes, so every solve past the first applies it for free."""
    applies = int(tail_iter) * (1 + int(ir_sweeps)) * max(int(s_chunk), 1)
    return applies >= int(n)


# ---------------- the fused mixed/df32 solve ----------------

def _fused_mixed_impl(factors, A_lo, data, q, state, eps_abs, eps_rel,
                      eps_abs_dua, eps_rel_dua, *, bulk_iter, tail_iter,
                      check_every, adaptive_rho, polish, polish_iters,
                      polish_chunk, stall_rel, ir_sweeps, l_inv, alpha=1.6):
    """qp_solve_mixed's phases as two solve calls: the same eps floors,
    factor handoff and budget split, without segments."""
    lo = torch.float32
    dt_hi = state.x.dtype
    split = isinstance(factors.A_s, SplitMatrix)
    if not isinstance(A_lo, (SplitMatrix, PackedMatrix)) \
            and A_lo.dtype != lo:
        # non-split mixed: the plan stages the dense operand, cast here
        A_lo = A_lo.to(lo)
    # cast around the pre-staged A_lo (f32 storage already)
    f_lo = _cast_floats(factors._replace(A_s=None), lo)._replace(A_s=A_lo)
    # the bulk never polishes, so its data's A is never read
    d_lo = _cast_floats(data._replace(A=A_lo), lo)
    st_lo = _cast_floats(state, lo)
    L_lo0 = st_lo.L
    if split and isinstance(L_lo0, LInv):
        # the bulk never applies the explicit inverse: carry the raw
        # factor through it, so an in-bulk refactorization does not
        # rebuild an inverse it would discard
        st_lo = st_lo._replace(L=L_lo0.tri)
    if not split:
        st_lo = st_lo._replace(L=_factorize(f_lo, st_lo.rho_scale))
    L_bulk_in = st_lo.L
    eps_lo, eps_rel_lo, eps_rel_lo_dua = _lo_eps(eps_abs, eps_rel,
                                                 eps_rel_dua)
    st_lo, _, _, _ = _solve_impl(
        f_lo, d_lo, q.to(lo), st_lo, bulk_iter, check_every, eps_lo,
        eps_rel_lo, alpha, adaptive_rho, False, polish_iters, 0, eps_lo,
        eps_rel_lo_dua, stall_rel)

    # handoff: rho and (in split mode) the f32 factor carry over
    rho_hi = st_lo.rho_scale.to(dt_hi)
    L_hi = st_lo.L
    if split:
        if l_inv and not isinstance(L_hi, LInv):
            # the factor is a pure function of rho_scale, and the bulk
            # hands back the very tensor it was given unless its rho
            # adaptation refactorized: then the flowed inverse is still
            # exact; otherwise build a fresh one, once per solve
            if isinstance(L_lo0, LInv) and L_hi is L_bulk_in:
                L_hi = L_lo0
            else:
                L_hi = make_l_inv(L_hi)
    else:
        L_hi = _factorize(factors, rho_hi)
    st_hi = _cast_floats(st_lo._replace(L=None), dt_hi)._replace(
        L=L_hi, rho_scale=rho_hi)
    st, x_un, yA_un, yB_un = _solve_impl(
        factors, data, q, st_hi, tail_iter, check_every, eps_abs, eps_rel,
        alpha, adaptive_rho, polish, polish_iters, polish_chunk,
        eps_abs_dua, eps_rel_dua, stall_rel, ir_sweeps)
    return st._replace(iters=st_lo.iters + st.iters), x_un, yA_un, yB_un


def fused_mixed_solve(factors, A_lo, data, q, state, *, bulk_iter,
                      tail_iter, check_every, eps_abs, eps_rel,
                      eps_abs_dua, eps_rel_dua, polish, polish_iters,
                      polish_chunk, stall_rel, ir_sweeps, l_inv,
                      adaptive_rho=True):
    """One fused mixed/df32 solve call (see _fused_mixed_impl). With
    ``l_inv``, a state arriving with a raw 2-D f32 Cholesky factor gets
    its L⁻¹ built here (booked as ``kernel.l_inv_factorizations``), so
    the whole chunk chain carries one container type."""
    if l_inv and not isinstance(state.L, LInv):
        L = state.L
        if getattr(L, "ndim", 0) == 2 and L.dtype == torch.float32:
            obs.counter_add("kernel.l_inv_factorizations")
            state = state._replace(L=make_l_inv(L))
    obs.counter_add("qp.solve_segments")
    return _fused_mixed_impl(
        factors, A_lo, data, q, state, eps_abs, eps_rel, eps_abs_dua,
        eps_rel_dua, bulk_iter=int(bulk_iter), tail_iter=int(tail_iter),
        check_every=int(check_every), adaptive_rho=bool(adaptive_rho),
        polish=bool(polish), polish_iters=int(polish_iters),
        polish_chunk=int(polish_chunk), stall_rel=float(stall_rel),
        ir_sweeps=int(ir_sweeps), l_inv=bool(l_inv))

