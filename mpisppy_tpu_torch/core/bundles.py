"""Bundling: group scenarios into bundle-EF subproblems (the port of the
JAX package's core/bundles.py; host numpy only).

The reference's ``bundles_per_rank`` groups the scenarios on a rank into
one EF subproblem to trade subproblem count for subproblem size
(ref. mpisppy/spbase.py:206-240 _assign_bundles, phbase.py:1273-1302
subproblem_creation + FormEF). Here it is a batch reshape: the (S,)
scenario axis becomes a (B,) bundle axis whose elements are
shared-column EFs of their members. PH, APH, L-shaped and the cylinders
then run unchanged over the bundled batch: fewer, larger subproblems,
one KKT factor per bundle.

Like the reference's PH bundles this is two-stage only (ref.
fwph.py:439-442 makes the same restriction for FWPH) and requires
S % n_bundles == 0 with consecutive members per bundle (the reference
assigns consecutive slices too, spbase.py:224-231).

When the source batch shares one (m, n) constraint matrix
(``ScenarioBatch.shared_A``), every bundle's matrix is the same by
construction, so the bundled batch keeps ONE (mB, nB) matrix, not a
(B, mB, nB) stack of copies (at the reference UC, S = 10 in 5 bundles,
7.3 GB instead of 36 GB); the engines' shared-structure detection then
runs the bundles on the shared-A solve path.

Why bundling helps (as in the reference): the bundle EF solves the
members' coupling exactly (a tighter trivial/Lagrangian bound:
E[min] over bundles ≥ E[min] over scenarios), and PH coordinates B
subproblems instead of S.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ir.batch import ScenarioBatch
from ..ir.tree import two_stage_tree
from ..utils.runtime import to_host


@dataclass
class BundleTemplate:
    """Just enough of StandardForm's surface for the engines."""
    var_slices: dict
    sense: str
    integer: np.ndarray


def _column_split(b):
    """(nonant columns, nonant mask, local columns) of a batch."""
    idx = np.asarray(b.nonant_idx)
    nonant_set = np.zeros(b.n, bool)
    nonant_set[idx] = True
    return idx, nonant_set, np.flatnonzero(~nonant_set)


def form_bundles(batch: ScenarioBatch, n_bundles: int) -> ScenarioBatch:
    """Reshape an S-scenario two-stage batch into an n_bundles-bundle
    batch of shared-column EFs. Columns are ordered [nonants (K), member-0
    locals, member-1 locals, ...]; rows are the members' rows stacked.
    A shared (m, n) source matrix gives one shared (mB, nB) bundle
    matrix; per-scenario matrices give a (B, mB, nB) stack."""
    b = batch
    S, n, m, K = b.S, b.n, b.m, b.K
    if b.tree.num_stages != 2:
        raise ValueError("bundling is two-stage only "
                         "(ref. fwph.py:439-442)")
    B = int(n_bundles)
    if B <= 0 or S % B != 0:
        raise ValueError(f"n_bundles={B} must divide S={S}")
    g = S // B
    idx, nonant_set, local_cols = _column_split(b)
    nl = local_cols.size
    nB = K + g * nl
    mB = g * m

    # member j of a bundle maps scenario columns -> bundle columns
    colmap = np.zeros((g, n), dtype=np.int64)
    for j in range(g):
        colmap[j, idx] = np.arange(K)
        colmap[j, local_cols] = K + j * nl + np.arange(nl)

    prob = np.asarray(b.prob)
    c_src, c0_src = np.asarray(b.c), np.asarray(b.c0)
    cs_src, c0s_src = np.asarray(b.c_stage), np.asarray(b.c0_stage)
    lb_src, ub_src = np.asarray(b.lb), np.asarray(b.ub)
    l_src, u_src = np.asarray(b.l), np.asarray(b.u)

    shared = b.shared_A
    A = np.zeros((mB, nB) if shared else (B, mB, nB))
    l = np.zeros((B, mB))
    u = np.zeros((B, mB))
    c = np.zeros((B, nB))
    c0 = np.zeros(B)
    P = np.zeros((B, nB))
    lb = np.full((B, nB), -np.inf)
    ub = np.full((B, nB), np.inf)
    c_stage = np.zeros((B, 2, nB))
    c0_stage = np.zeros((B, 2))
    bprob = prob.reshape(B, g).sum(axis=1)
    if np.asarray(b.P_diag).any():
        raise ValueError("bundling currently supports linear objectives "
                         "(P_diag == 0)")
    if (bprob <= 0.0).any():
        raise ValueError("every bundle needs positive total probability "
                         "(a zero-probability bundle has no conditional "
                         "member weights)")

    def place(dst, A_s, j):
        """Member j's rows of a bundle matrix: A_s's nonant columns onto
        the first K columns, its local columns onto member j's block
        (colmap[j] as two block copies)."""
        rows = slice(j * m, (j + 1) * m)
        dst[rows, :K] = A_s[:, idx]
        dst[rows, K + j * nl:K + (j + 1) * nl] = A_s[:, local_cols]

    if shared:
        A_src = np.asarray(b.A)
        for j in range(g):
            place(A, A_src, j)

    for bi in range(B):
        members = range(bi * g, (bi + 1) * g)
        for j, s in enumerate(members):
            w = prob[s] / bprob[bi]     # conditional member weight
            rows = slice(j * m, (j + 1) * m)
            if not shared:
                place(A[bi], np.asarray(b.A_of(s)), j)
            l[bi, rows] = l_src[s]
            u[bi, rows] = u_src[s]
            np.add.at(c[bi], colmap[j], w * c_src[s])
            c0[bi] += w * c0_src[s]
            for t in range(2):
                np.add.at(c_stage[bi, t], colmap[j], w * cs_src[s, t])
                c0_stage[bi, t] += w * c0s_src[s, t]
            lb[bi, colmap[j]] = np.maximum(lb[bi, colmap[j]], lb_src[s])
            ub[bi, colmap[j]] = np.minimum(ub[bi, colmap[j]], ub_src[s])

    integer = np.zeros(nB, bool)
    int_src = np.asarray(b.integer)
    integer[:K] = int_src[idx]
    for j in range(g):
        integer[K + j * nl: K + (j + 1) * nl] = int_src[local_cols]

    var_slices = {"nonants": slice(0, K)}
    for name, sl in b.template.var_slices.items():
        # whole var groups are either fully nonant or fully local
        # (nonant_idx is built group-wise, ir/batch.py); locals keep
        # per-member names for reporting
        group_cols = np.arange(n)[sl]
        if group_cols.size == 0 or nonant_set[group_cols].any():
            continue
        for j in range(g):
            cols = colmap[j, sl]
            var_slices[f"{name}@m{j}"] = slice(int(cols[0]),
                                               int(cols[-1]) + 1)
    template = BundleTemplate(var_slices=var_slices,
                              sense=b.template.sense, integer=integer)

    tree = two_stage_tree([f"bundle{i}" for i in range(B)],
                          nonant_names=["nonants"], probabilities=bprob)
    return ScenarioBatch(
        tree=tree, template=template,
        c=c, c0=c0, P_diag=P, A=A, l=l, u=u, lb=lb, ub=ub,
        c_stage=c_stage, c0_stage=c0_stage, prob=bprob,
        nonant_idx=np.arange(K, dtype=np.int32),
        nonant_stage=np.ones(K, dtype=np.int32),
        stage_slot_slices=[slice(0, K)],
    )


def unbundle_x(batch: ScenarioBatch, bundled: ScenarioBatch, xB):
    """Map a bundled solution block (B, nB) back to (S, n) scenario form.
    ``xB``: host numpy or a tensor on any device."""
    b = batch
    S, n, K = b.S, b.n, b.K
    B = bundled.S
    g = S // B
    idx, _, local_cols = _column_split(b)
    nl = local_cols.size
    xB = to_host(xB)
    x = np.zeros((S, n))
    for bi in range(B):
        for j in range(g):
            s = bi * g + j
            x[s, idx] = xB[bi, :K]
            x[s, local_cols] = xB[bi, K + j * nl: K + (j + 1) * nl]
    return x
