"""Progressive problem shrinking: the device fixer's counters, per-slot
adaptive rho and active-set compaction (the port of the JAX package's
ops/shrink.py, native precision).

1. ``fixer_update``: the WW fixer's test-and-fix (extensions/fixer.py)
   as torch ops over the engine's (S, K) state: per-slot consecutive-
   converged counters, bound-parking streaks and the accumulated fix
   mask and values. The host reads one scalar per pass, the fixed-slot
   count.

2. ``ShrinkPlan`` / ``build_plan`` and the fold/expand ops: when the
   fixed fraction crosses a bucketed threshold, the unfixed columns and
   the constraint rows they touch are gathered into a smaller system;
   the fixed columns fold into per-scenario constants (``c0_fold``, the
   rhs shift), so the EXPANDED solution of the compacted system is the
   pinned full solve's to solver tolerance. Plans are built from the
   full data at every transition, never incrementally.

3. ``per_slot_rho_update``: NormRhoUpdater's residual balancing per
   nonant SLOT, returning the new rho and one packed (3,) stats row
   ([changed, prim_sum, dual_sum]), so the host pays one small read per
   update.

Every function takes and returns tensors on the caller's device. Torch
compiles nothing per shape, so the JAX package's shape-bucket registry
(``shrink.bucket.*``) has no counterpart here; a compacted shape costs
one factorization per (transition, mode), which core/ph books.

The split-f32 (df32) compaction of the JAX package (``_split_fixed_shift``,
``_unscale_split_blocks``) is not ported (ROADMAP.md A9b).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .qp_solver import QPData

# "never fix" threshold sentinel (2^30 consecutive converged iterations)
INT_NEVER = 2 ** 30

# rows per block of the plan's gathers: one block's transient is
# ROW_BLOCK x n_c entries, not a second copy of A
ROW_BLOCK = 4096


# ---------------- device fixer counters ----------------

def _over_ranks(mesh, t, how):
    """``t`` reduced over a sharded mesh's ranks ("max", "all" or
    "sum"); ``t`` itself without one."""
    if mesh is None or mesh.size == 1:
        return t
    if how == "all":
        return mesh.all_min(t.to(torch.uint8)).bool()
    return mesh.all_max(t) if how == "max" else mesh.all_sum(t)


def fixer_update(conv_count, lb_count, ub_count, fixed_mask, fixed_vals,
                 xbar, xsqbar, xn, slot_lb, slot_ub, tol, boundtol, nbc,
                 lbc, ubc, imask, mesh=None):
    """One ``miditer`` of the WW fixer as device ops, the host Fixer's
    pass exactly: variance test per slot, parked-at-bound streaks,
    lb > ub > nb precedence, integral snap, accumulate-only fixing.
    Returns the updated counters, mask and values plus the fixed-slot
    count as a device scalar, the one number the host reads. On a
    sharded ``mesh`` the per-slot tests reduce over every rank's rows,
    so every rank fixes the same slots."""
    var = _over_ranks(mesh, torch.amax(torch.abs(xsqbar - xbar * xbar),
                                       dim=0), "max")
    agree = var <= tol * tol + 1e-15
    conv_count = torch.where(agree, conv_count + 1, 0)
    at_lb = _over_ranks(mesh, torch.all(
        torch.abs(xn - slot_lb) <= boundtol, dim=0), "all")
    at_ub = _over_ranks(mesh, torch.all(
        torch.abs(xn - slot_ub) <= boundtol, dim=0), "all")
    lb_count = torch.where(agree & at_lb, lb_count + 1, 0)
    ub_count = torch.where(agree & at_ub, ub_count + 1, 0)
    fix_lb = lb_count >= lbc
    fix_ub = (ub_count >= ubc) & ~fix_lb
    fix_nb = (conv_count >= nbc) & ~fix_lb & ~fix_ub
    newly = (fix_lb | fix_ub | fix_nb) & ~fixed_mask[0]
    value = torch.where(fix_lb.unsqueeze(0), slot_lb,
                        torch.where(fix_ub.unsqueeze(0), slot_ub, xbar))
    value = torch.where(imask.unsqueeze(0), torch.round(value), value)
    fixed_vals = torch.where(newly.unsqueeze(0), value, fixed_vals)
    fixed_mask = fixed_mask | newly.unsqueeze(0)
    n_fixed = fixed_mask[0].sum()
    return conv_count, lb_count, ub_count, fixed_mask, fixed_vals, n_fixed


# ---------------- per-slot adaptive rho ----------------

def per_slot_rho_update(rho, prob, xn, xbar, xbar_prev, mult, factor,
                        mesh=None):
    """Residual-balancing rho update PER NONANT SLOT: prim_k is the
    probability-weighted primal residual of slot k, dual_k the
    rho-scaled dual residual; slots with prim > mult*dual scale up,
    dual > mult*prim scale down. The factor is per slot, so a rho
    uniform across scenarios stays uniform and the single-factor prox
    path keeps working. On a sharded ``mesh`` the sums run over every
    rank's rows (one all-reduce). Returns (new_rho, stats), stats the
    packed (3,) row [changed, prim_sum, dual_sum]."""
    K = xn.shape[1]
    sums = _over_ranks(mesh, torch.cat([
        prob @ torch.abs(xn - xbar), torch.sum(rho, dim=0),
        torch.sum(torch.abs(xbar - xbar_prev), dim=0),
        torch.tensor([float(xn.shape[0])], dtype=rho.dtype,
                     device=rho.device)]), "sum")
    prim, rho_sum, dx = sums[:K], sums[K:2 * K], sums[2 * K:3 * K]
    S = sums[3 * K]
    if mesh is None or mesh.size == 1:
        dual = torch.mean(rho, dim=0) \
            * torch.sum(torch.abs(xbar - xbar_prev), dim=0) / S
    else:
        dual = rho_sum / S * dx / S
    up = prim > mult * dual
    down = (dual > mult * prim) & ~up
    one = torch.ones_like(prim)
    scale = torch.where(up, factor * one,
                        torch.where(down, one / factor, one))
    new_rho = rho * scale.unsqueeze(0)
    changed = torch.any(up | down).to(rho.dtype)
    stats = torch.stack([changed, torch.sum(prim), torch.sum(dual)])
    return new_rho, stats


# ---------------- active-set compaction ----------------

@dataclass
class ShrinkPlan:
    """One compacted system: device tensors and host metadata, built by
    :func:`build_plan` at a bucket transition. The engine solves the
    compacted system and expands its solutions back through
    :func:`expand_solution`."""
    bucket: float                 # the threshold fraction crossed
    n_full: int
    m_full: int
    n_c: int                      # kept columns
    m_c: int                      # kept rows
    n_fixed_slots: int
    free_slots: np.ndarray        # (K_c,) host slot ids kept
    fixed_slots: np.ndarray       # (K_f,) host slot ids folded out
    keep_cols: torch.Tensor       # (n_c,) original column ids
    fixed_cols: torch.Tensor      # (n_f,) folded column ids
    free_slots_dev: torch.Tensor  # (K_c,)
    fixed_slots_dev: torch.Tensor  # (K_f,) for the dual fold
    idx_c: torch.Tensor           # (K_c,) free-slot positions in keep_cols
    fixed_colvals: torch.Tensor   # (S, n_f) folded values
    data_c: QPData                # the compacted problem data
    c_c: torch.Tensor             # (S, n_c) compacted linear cost
    c0_fold: torch.Tensor         # (S,) c0 + the fixed columns' cost
    rhs_shift: torch.Tensor       # (S, m_c) folded rhs shift (l and u
    #                               moved by -shift; the transplant
    #                               re-centres row slacks through it)
    keep_rows_np: np.ndarray      # (m_c,) host row ids kept
    keep_cols_np: np.ndarray      # (n_c,) host column ids kept


def _gather_2d(A, rows, cols):
    """A[rows][:, cols] of a shared (m, n) A through index_select, in
    row blocks: the output plus one block's transient, never a second
    (m_c, n) copy."""
    out = torch.empty((rows.numel(), cols.numel()), dtype=A.dtype,
                      device=A.device)
    for i in range(0, rows.numel(), ROW_BLOCK):
        r = rows[i:i + ROW_BLOCK]
        out[i:i + r.numel()] = A.index_select(0, r).index_select(1, cols)
    return out


def _rows_touching(A, cols):
    """(m,) bool: the rows of A with a nonzero in ``cols`` (in any
    scenario of a batched A), computed in row blocks."""
    if A.ndim == 3:
        return (A.index_select(2, cols) != 0).any(dim=2).any(dim=0)
    out = torch.empty(A.shape[0], dtype=torch.bool, device=A.device)
    for i in range(0, A.shape[0], ROW_BLOCK):
        blk = A[i:i + ROW_BLOCK].index_select(1, cols)
        out[i:i + blk.shape[0]] = (blk != 0).any(dim=1)
    return out


def _fold_compact(A, l, u, lb, ub, P_diag, c, c0, keep_rows, keep_cols,
                  fixed_cols, fv):
    """Compaction of one system: gather the kept rows and columns and
    fold the fixed columns' contributions into the rhs (l/u shifts) and
    the objective constant. Shared (m, n) and batched (S, m, n) A."""
    if A.ndim == 2:
        A_c = _gather_2d(A, keep_rows, keep_cols)
        A_f = _gather_2d(A, keep_rows, fixed_cols)
        shift = fv @ A_f.T                     # (S, m_c)
    else:
        A_keep = A.index_select(1, keep_rows)
        A_c = A_keep.index_select(2, keep_cols)
        A_f = A_keep.index_select(2, fixed_cols)   # (S, m_c, n_f)
        shift = torch.einsum("smf,sf->sm", A_f, fv)
    del A_f
    vecs = _fold_vectors(l, u, lb, ub, P_diag, c, c0, keep_rows,
                         keep_cols, fixed_cols, fv, shift)
    return (A_c,) + vecs + (shift,)


def _fold_vectors(l, u, lb, ub, P_diag, c, c0, keep_rows, keep_cols,
                  fixed_cols, fv, shift):
    """The vector half of :func:`_fold_compact`, the rhs shift given."""
    l_c = l.index_select(1, keep_rows) - shift
    u_c = u.index_select(1, keep_rows) - shift
    lb_c = lb.index_select(1, keep_cols)
    ub_c = ub.index_select(1, keep_cols)
    P_c = P_diag.index_select(-1, keep_cols)
    c_c = c.index_select(1, keep_cols)
    P_f = P_diag.index_select(-1, fixed_cols)
    c0_fold = c0 + torch.sum(c.index_select(1, fixed_cols) * fv, dim=1) \
        + 0.5 * torch.sum(P_f * fv * fv, dim=-1)
    return l_c, u_c, lb_c, ub_c, P_c, c_c, c0_fold


def dual_fold(c0_fold, vals, W, xbar, rho, wscale, *, w_on, prox_on):
    """Per-iteration dual-bound constant of the compacted system: the
    assembled-objective contribution of the FOLDED columns. The base
    fold (c·v + ½P·v², computed once per compaction) rides ``c0_fold``;
    the W and prox-centre terms move every PH iteration and fold here
    from the fixed-slot blocks, the same combination core/ph
    ``_ph_assemble`` adds for the free slots. With this constant the
    compacted solve's qp_dual_objective certifies the bound of the
    uncompacted PINNED solve."""
    Weff = W if wscale is None else W * wscale
    if w_on and prox_on:
        wvec = Weff - rho * xbar
    elif w_on:
        wvec = Weff
    elif prox_on:
        wvec = -rho * xbar
    else:
        wvec = torch.zeros_like(W)
    fold = c0_fold + torch.sum(wvec * vals, dim=1)
    if prox_on:
        fold = fold + 0.5 * torch.sum(rho * vals * vals, dim=1)
    return fold


def expand_solution(x_c, fv, keep_cols, fixed_cols, n):
    """Scatter a compacted solution block back to full width ``n``:
    x_full[:, keep] = x_c, x_full[:, fixed] = the folded values."""
    out = torch.zeros((x_c.shape[0], int(n)), dtype=x_c.dtype,
                      device=x_c.device)
    out = out.index_copy(1, keep_cols, x_c)
    return out.index_copy(1, fixed_cols, fv.to(x_c.dtype))


def build_plan(qp_data: QPData, c, c0, nonant_idx, fixed_mask, fixed_vals,
               bucket, *, dtype, mesh=None) -> ShrinkPlan | None:
    """The compaction plan for the CURRENT fixed set against the FULL
    system (plans are always derived from the full data, so transitions
    stay independent and exact).

    Host staging happens once per bucket transition: the fixed-slot mask
    comes down as one (S, K) bool block and the kept-row pattern as one
    (m,) bool vector. Returns None when nothing, or everything, would
    compact."""
    fm = fixed_mask.cpu().numpy()          # one read per transition
    slot_fixed = fm.all(axis=0)
    idx_np = nonant_idx.cpu().numpy()
    fixed_slots = np.flatnonzero(slot_fixed)
    free_slots = np.flatnonzero(~slot_fixed)
    if fixed_slots.size == 0 or free_slots.size == 0:
        return None
    A = qp_data.A
    dev = A.device
    n = int(A.shape[-1])
    m = int(A.shape[-2])
    fixed_cols = np.sort(idx_np[fixed_slots])
    keep_cols = np.setdiff1d(np.arange(n), fixed_cols)
    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    keep_dev = ids(keep_cols)
    # rows that still touch a kept column IN ANY SCENARIO; rows whose
    # every nonzero is a fixed column reduce to constants and go with
    # them
    # (on a sharded mesh, in any scenario of any rank)
    keep_rows = np.flatnonzero(_over_ranks(
        mesh, _rows_touching(A, keep_dev).to(torch.uint8), "max")
        .cpu().numpy())    # one (m,) read
    if keep_rows.size == 0:
        return None
    fixed_dev = ids(fixed_cols)
    rows_dev = ids(keep_rows)
    # folded values in ORIGINAL column order (nonant slots -> columns)
    order = np.argsort(idx_np[fixed_slots])
    fv = fixed_vals.to(dtype).index_select(1, ids(fixed_slots[order]))
    A_c, l_c, u_c, lb_c, ub_c, P_c, c_c, c0_fold, shift = _fold_compact(
        A, qp_data.l, qp_data.u, qp_data.lb, qp_data.ub, qp_data.P_diag,
        c, c0, rows_dev, keep_dev, fixed_dev, fv)
    idx_c = np.searchsorted(keep_cols, idx_np[free_slots])
    return ShrinkPlan(
        bucket=float(bucket), n_full=n, m_full=m,
        n_c=int(keep_cols.size), m_c=int(keep_rows.size),
        n_fixed_slots=int(fixed_slots.size),
        free_slots=free_slots, fixed_slots=fixed_slots,
        keep_cols=keep_dev, fixed_cols=fixed_dev,
        free_slots_dev=ids(free_slots), fixed_slots_dev=ids(fixed_slots),
        idx_c=ids(idx_c), fixed_colvals=fv,
        data_c=QPData(P_c, A_c, l_c, u_c, lb_c, ub_c), c_c=c_c,
        c0_fold=c0_fold, rhs_shift=shift, keep_rows_np=keep_rows,
        keep_cols_np=keep_cols)


# ---------------- cross-bucket warm transplant ----------------

def _transplant_rescale(x, yA, yB, zA, zB, pos_cols, pos_rows, D_old,
                        D_new, E_old, E_new, Eb_old, Eb_new, cs_ratio,
                        shift_old, shift_new, ok):
    """Gather and rescale one mode's SCALED warm ADMM iterates from the
    old width into a new compacted width (the caller checks that the
    new kept set nests in the old one and builds ``pos_cols`` /
    ``pos_rows``: new position j came from old position pos[j]).

    With x = x_u / D, yA = cs·y_u / E, yB = cs·y_u / Eb, zA = E·(A x_u −
    shift) and zB = Eb·x_u, the same unscaled point under the new
    factors' (D, E, Eb, cost_scale, shift) is

        x'  = x[pos_c]  · D_old[pos_c] / D_new
        yA' = yA[pos_r] · cs_ratio · E_old[pos_r] / E_new
        yB' = yB[pos_c] · cs_ratio · Eb_old[pos_c] / Eb_new
        zA' = E_new · (zA[pos_r] / E_old[pos_r] + shift_old[:, pos_r]
                       − shift_new)
        zB' = zB[pos_c] · Eb_new / Eb_old[pos_c]

    Scaling vectors may be shared (1-D) or per scenario (2-D);
    ``cs_ratio`` a scalar or (S,). ``ok`` is an (S,) keep mask: excluded
    rows become the cold state's zeros."""
    def b2(v):
        return v if v.ndim == 2 else v.unsqueeze(0)

    csr = cs_ratio if cs_ratio.ndim == 0 else cs_ratio.unsqueeze(-1)
    okf = ok.to(x.dtype).unsqueeze(-1)
    x_n = x[:, pos_cols] * b2(D_old)[:, pos_cols] / b2(D_new) * okf
    yA_n = yA[:, pos_rows] * csr \
        * (b2(E_old)[:, pos_rows] / b2(E_new)) * okf
    yB_n = yB[:, pos_cols] * csr \
        * (b2(Eb_old)[:, pos_cols] / b2(Eb_new)) * okf
    zA_n = (b2(E_new)
            * (zA[:, pos_rows] / b2(E_old)[:, pos_rows]
               + shift_old[:, pos_rows] - shift_new)) * okf
    zB_n = zB[:, pos_cols] * (b2(Eb_new) / b2(Eb_old)[:, pos_cols]) * okf
    return x_n, yA_n, yB_n, zA_n, zB_n
