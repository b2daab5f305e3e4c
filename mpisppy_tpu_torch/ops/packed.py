"""Structure-packed shared constraint matrix (the port of
mpisppy_tpu/ops/packed.py): the matvec representation that keeps the
df32 hot loop from streaming the zeros of a dense (m, n) matrix.

SP constraint matrices are structured rather than generally sparse:

 - a few GLOBAL rows coupling most columns (UC: the per-hour balance
   and reserve rows), and
 - a block-local remainder: rows touching one small column group (UC:
   the capacity, startup, min-up/down and ramp rows of one generator).

Union-find on the host sparsity pattern (``analyze_structure``, at ship
time) finds this split with no model-specific code: rows above an nnz
threshold go global, the rest partition into connected components of
shared columns. The packed apply is then one batched block product over
the (C, mr, nc) component blocks plus one thin (R, n) product for the
global rows. On the 90 x 48 UC instance the packed operands are about
1.5 % of the dense matrix's bytes.

Exactness: each nonzero lands in exactly one term (components are
bounding boxes over disjoint row and column sets; global rows are
disjoint from local ones), so the packed apply equals the dense apply
up to f32 summation order. The JAX package scatters the block results
back with ``.at[].add``; on CUDA a scatter-add is atomic and its order
of summation varies from call to call. Because the real indices are
disjoint, ``pack`` builds the inverse maps once (dense row or column ->
its slot in the block results, or a zero slot) and the apply gathers
only: deterministic by construction, so chunked runs reproduce
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PackStructure(NamedTuple):
    """Host index skeleton (no values yet), numpy int arrays; padding
    entries are -1 and are masked at ``pack`` time."""
    g_rows: np.ndarray     # (R,) global-row indices (may be empty)
    l_rows: np.ndarray     # (C, mr), -1 padded
    l_cols: np.ndarray     # (C, nc), -1 padded


class Packed(NamedTuple):
    """PackStructure + gathered values of ONE dense matrix, on its
    device. Index padding is clamped to 0 (its values are zeroed).
    ``row_src`` maps each dense row to its slot in the concatenation
    [block results (C·mr), global-row results (R), one zero]; ``col_src``
    maps each dense column to its slot in [block results (C·nc), one
    zero]."""
    g_rows: torch.Tensor   # (R,) long
    g_vals: torch.Tensor   # (R, n)
    l_rows: torch.Tensor   # (C, mr) long, padding clamped to 0
    l_cols: torch.Tensor   # (C, nc) long, padding clamped to 0
    l_vals: torch.Tensor   # (C, mr, nc), padded rows/cols zeroed
    row_src: torch.Tensor  # (m,) long
    col_src: torch.Tensor  # (n,) long


def analyze_structure(rows, cols, m, n, nnz_thresholds=None,
                      max_tile=2048, max_traffic_ratio=0.35,
                      max_global_frac=0.25, max_attempts=16):
    """Host structure discovery from the COO pattern (rows, cols), as in
    the JAX package. Returns a PackStructure, or None when the matrix
    has no profitable global/local split (callers keep the dense path).

    Tries progressively stricter nnz thresholds for the global-row set,
    derived from the distinct per-row nnz values (descending); accepts
    the first whose components fit ``max_tile`` and whose packed operand
    bytes stay below ``max_traffic_ratio`` of dense."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if rows.size == 0:
        return None
    row_nnz = np.bincount(rows, minlength=m)
    if nnz_thresholds is None:
        distinct = np.unique(row_nnz[row_nnz > 1])[::-1]
        if distinct.size > max_attempts:
            # keep the small end dense (fine cuts matter there) and
            # subsample the large end
            head = distinct[distinct <= 64]
            tail = distinct[distinct > 64]
            if tail.size > max_attempts - head.size:
                sel = np.linspace(0, tail.size - 1,
                                  max(1, max_attempts - head.size))
                tail = tail[sel.astype(int)]
            distinct = np.concatenate([tail, head])[:max_attempts]
        nnz_thresholds = [int(v) for v in distinct]

    for thr in nnz_thresholds:
        g_mask = row_nnz > thr
        if g_mask.sum() > max_global_frac * m:
            continue
        local = ~g_mask[rows]
        lr, lc = rows[local], cols[local]
        if lr.size == 0:
            return None
        # connected components of the bipartite row/column graph: nodes
        # 0..n-1 are columns, n.. the local rows (reindexed)
        from scipy.sparse import coo_matrix, csgraph
        row_ids, rpos = np.unique(lr, return_inverse=True)
        g = coo_matrix((np.ones(lr.size, np.int8), (lc, n + rpos)),
                       shape=(n + row_ids.size, n + row_ids.size))
        _, labels = csgraph.connected_components(g, directed=False)
        used_cols = np.unique(lc)
        # deterministic component ids: first appearance over ascending
        # used-column index
        comp_ids = {}
        for lab in labels[used_cols]:
            comp_ids.setdefault(int(lab), len(comp_ids))
        C = len(comp_ids)
        col_lists = [[] for _ in range(C)]
        for c in used_cols:
            col_lists[comp_ids[int(labels[c])]].append(c)
        row_lists = [[] for _ in range(C)]
        for i, r in enumerate(row_ids):
            row_lists[comp_ids[int(labels[n + i])]].append(r)
        mr = max(len(x) for x in row_lists)
        nc = max(len(x) for x in col_lists)
        if mr > max_tile or nc > max_tile:
            continue
        R = int(g_mask.sum())
        if C * mr * nc + R * n > max_traffic_ratio * m * n:
            continue
        l_rows = np.full((C, mr), -1, np.int64)
        l_cols = np.full((C, nc), -1, np.int64)
        for i, (rl, cl) in enumerate(zip(row_lists, col_lists)):
            l_rows[i, :len(rl)] = rl
            l_cols[i, :len(cl)] = cl
        return PackStructure(
            g_rows=np.flatnonzero(g_mask).astype(np.int64),
            l_rows=l_rows, l_cols=l_cols)
    return None


def pk_nbytes(pk: Packed) -> int:
    """Bytes of matrix operands one packed A-pass reads (the value
    arrays; the index vectors are small)."""
    return int(pk.g_vals.numel() * pk.g_vals.element_size()
               + pk.l_vals.numel() * pk.l_vals.element_size())


def _inverse_maps(structure: PackStructure, m, n):
    """(row_src, col_src) of the gather-only apply (see Packed)."""
    l_rows, l_cols = structure.l_rows, structure.l_cols
    C, mr = l_rows.shape
    nc = l_cols.shape[1]
    R = structure.g_rows.size
    row_src = np.full(m, C * mr + R, np.int64)     # the zero slot
    real = l_rows.reshape(-1) >= 0
    row_src[l_rows.reshape(-1)[real]] = np.flatnonzero(real)
    row_src[structure.g_rows] = C * mr + np.arange(R)
    col_src = np.full(n, C * nc, np.int64)
    real = l_cols.reshape(-1) >= 0
    col_src[l_cols.reshape(-1)[real]] = np.flatnonzero(real)
    return row_src, col_src


def pack(structure: PackStructure, dense: torch.Tensor) -> Packed:
    """Gather one dense (m, n) device matrix into packed form. Padded
    index slots clamp to 0 for the gather and their values are zeroed:
    position (0, c) holds real data that must not leak into padding."""
    dev = dense.device
    m, n = dense.shape
    lr_np = np.maximum(structure.l_rows, 0)
    lc_np = np.maximum(structure.l_cols, 0)
    mask_np = (structure.l_rows >= 0)[:, :, None] \
        & (structure.l_cols >= 0)[:, None, :]
    lr = torch.as_tensor(lr_np, device=dev)
    lc = torch.as_tensor(lc_np, device=dev)
    vals = dense[lr[:, :, None], lc[:, None, :]]
    vals = torch.where(torch.as_tensor(mask_np, device=dev), vals,
                       torch.zeros((), dtype=dense.dtype, device=dev))
    g_rows = torch.as_tensor(structure.g_rows, device=dev)
    row_src, col_src = _inverse_maps(structure, m, n)
    return Packed(g_rows=g_rows, g_vals=dense[g_rows].contiguous(),
                  l_rows=lr, l_cols=lc, l_vals=vals.contiguous(),
                  row_src=torch.as_tensor(row_src, device=dev),
                  col_src=torch.as_tensor(col_src, device=dev))


def _gather_rows(pk: Packed, loc, glob, S):
    """(S, m) from the block results (S, C, mr) and the global-row
    results (S, R) or None, by one gather through ``row_src``."""
    parts = [loc.reshape(S, -1)]
    if glob is not None:
        parts.append(glob)
    parts.append(torch.zeros((S, 1), dtype=loc.dtype, device=loc.device))
    return torch.cat(parts, dim=1)[:, pk.row_src]


def _gather_cols(pk: Packed, loc, S):
    """(S, n) from the block results (S, C, nc) through ``col_src``."""
    flat = torch.cat([loc.reshape(S, -1),
                      torch.zeros((S, 1), dtype=loc.dtype,
                                  device=loc.device)], dim=1)
    return flat[:, pk.col_src]


def pk_Ax(pk: Packed, x, m):
    """A x via the packed form: x (S, n) -> (S, m)."""
    S = x.shape[0]
    xg = x[:, pk.l_cols]                          # (S, C, nc)
    loc = torch.einsum("scn,cmn->scm", xg, pk.l_vals)
    glob = x @ pk.g_vals.T if pk.g_rows.numel() else None
    return _gather_rows(pk, loc, glob, S)


def pk_ATy(pk: Packed, y, n):
    """Aᵀ y via the packed form: y (S, m) -> (S, n)."""
    S = y.shape[0]
    yg = y[:, pk.l_rows]                          # (S, C, mr)
    loc = torch.einsum("scm,cmn->scn", yg, pk.l_vals)
    out = _gather_cols(pk, loc, S)
    if pk.g_rows.numel():
        out = out + y[:, pk.g_rows] @ pk.g_vals
    return out


def pk_Ax_split(pk_hi: Packed, pk_lo: Packed, xh, xl, m):
    """The df32 three-pass matvec (hi·xh + lo·xh + hi·xl, accumulated in
    f64: the SplitMatrix contract) through the packed form. hi and lo
    share one index skeleton, so x gathers once per operand and the
    three f32 block results add in f64 before the one gather."""
    S = xh.shape[0]
    f64 = torch.float64
    xgh = xh[:, pk_hi.l_cols]
    xgl = xl[:, pk_hi.l_cols]
    loc = (torch.einsum("scn,cmn->scm", xgh, pk_hi.l_vals).to(f64)
           + torch.einsum("scn,cmn->scm", xgh, pk_lo.l_vals).to(f64)
           + torch.einsum("scn,cmn->scm", xgl, pk_hi.l_vals).to(f64))
    glob = None
    if pk_hi.g_rows.numel():
        glob = ((xh @ pk_hi.g_vals.T).to(f64)
                + (xh @ pk_lo.g_vals.T).to(f64)
                + (xl @ pk_hi.g_vals.T).to(f64))
    return _gather_rows(pk_hi, loc, glob, S)


def pk_ATy_split(pk_hi: Packed, pk_lo: Packed, yh, yl, n):
    """Transpose twin of pk_Ax_split."""
    S = yh.shape[0]
    f64 = torch.float64
    ygh = yh[:, pk_hi.l_rows]
    ygl = yl[:, pk_hi.l_rows]
    loc = (torch.einsum("scm,cmn->scn", ygh, pk_hi.l_vals).to(f64)
           + torch.einsum("scm,cmn->scn", ygh, pk_lo.l_vals).to(f64)
           + torch.einsum("scm,cmn->scn", ygl, pk_hi.l_vals).to(f64))
    out = _gather_cols(pk_hi, loc, S)
    if pk_hi.g_rows.numel():
        yhg = yh[:, pk_hi.g_rows]
        out = out + ((yhg @ pk_hi.g_vals).to(f64)
                     + (yhg @ pk_lo.g_vals).to(f64)
                     + (yl[:, pk_hi.g_rows] @ pk_hi.g_vals).to(f64))
    return out
