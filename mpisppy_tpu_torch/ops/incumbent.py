"""Device-side batched incumbent search: candidate pools over the nonants
(the port of the JAX package's ops/incumbent.py).

Manufacture a POOL of rounding candidates from the hub's consensus block
as one op over the (scenario x var) nonant matrix, then evaluate the
whole pool as ordinary chunks of batched fix-and-dive repair solves
(core/ph.PHBase.evaluate_incumbent_pool).

Pool anatomy (``build_pool``), P = len(thresholds) + flips + n_random + 4
(two slam rows + two bound rows):

- VOTE rows: probability-weighted vote rounding of the consensus at
  each threshold (commit every dive slot the fleet runs at >= tau);
- FLIP rows: the top-k MOST fractional dive slots of the consensus each
  flipped individually on the tau=0.5 base candidate;
- RANDOM rows: seeded radius-``ball`` random flip neighborhoods of the
  base candidate, deterministic per (seed, round). The generator is
  torch's (a CPU ``torch.Generator`` seeded from seed and round), not
  jax's threefry: the JAX package draws other neighborhoods, so these
  rows match it in kind, not bit for bit (ROADMAP.md C.1);
- SLAM rows: the per-variable max/min over scenarios;
- BOUND rows: the dive slots at their upper / lower bounds (the
  covering-model feasible anchor).

``pool_verdict`` fuses the feasibility screen and the expected-objective
reduction so the caller pays exactly ONE stacked device-to-host read
per round.
"""

from __future__ import annotations

import numpy as np
import torch


def slam_rows(X):
    """(up, down): per-variable max/min over the scenario axis of a
    (S, K) nonant block — the slam heuristics' two candidates
    (ref. mpisppy/cylinders/slam_heuristic.py:24-153). The ONE host
    implementation, shared by the slam spokes and mirrored by
    ``build_pool``'s slam block."""
    X = np.asarray(X)
    return X.max(axis=0), X.min(axis=0)


def pool_size(n_dive, thresholds=(0.3, 0.5, 0.7), flips=8, n_random=4):
    """Pool row count for the given dive-slot count (identical for the
    deterministic and the ``random_only`` builds). The +4 is the two
    slam rows plus the two bound rows."""
    n_dive = int(n_dive)
    return (len(tuple(thresholds)) + min(int(flips), n_dive)
            + (int(n_random) if n_dive else 0) + 4)


def _random_rows(base, dive_idx, count, ball, seed, round_index):
    """``count`` candidates, each ``base`` with ``ball`` distinct dive
    slots flipped, drawn from a generator seeded by (seed, round)."""
    g = torch.Generator()
    g.manual_seed((int(seed) & 0xFFFFFFFF) << 32
                  | (int(round_index) & 0xFFFFFFFF))
    rows = base.unsqueeze(0).repeat(count, 1)
    for i in range(count):
        pick = torch.randperm(dive_idx.numel(), generator=g)[:ball]
        sel = dive_idx[pick.to(dive_idx.device)]
        rows[i, sel] = 1.0 - base[sel]
    return rows


def _build_pool(X, prob, dive_mask, int_mask, dive_idx, lb_row, ub_row,
                seed, round_index, *, thresholds, flips, ball, n_random,
                random_only):
    """The pool builder over the (S, K) nonant matrix (tensors on one
    device). ``dive_mask`` (K,) bool: the BINARY nonant slots a
    candidate decides; everything else carries the raw consensus value.
    ``int_mask`` (K,) bool: all integer slots, snapped to integral
    values so every row is evaluation-ready. ``random_only``: seeded
    random neighborhoods of the base candidate in place of the
    deterministic blocks, with the SAME row count."""
    w = prob / torch.clamp(prob.sum(), min=1e-300)
    cons = w @ X                                            # (K,)
    base = torch.where(dive_mask, (cons >= 0.5).to(X.dtype), cons)
    n_total = len(thresholds) + flips + n_random + 4
    if random_only:
        pool = _random_rows(base, dive_idx, n_total, ball, seed,
                            round_index)
    else:
        rows = [torch.where(dive_mask, (cons >= tau).to(X.dtype),
                            cons).unsqueeze(0)
                for tau in thresholds]
        if flips:
            # most-fractional-first: the slots the fleet most disagrees
            # on (non-dive slots key to -1 so they never enter the ball);
            # a stable sort breaks ties toward the lower index, as
            # jax.lax.top_k does
            frac = torch.where(dive_mask, (cons - torch.round(cons)).abs(),
                               -1.0)
            top = torch.sort(frac, descending=True,
                             stable=True).indices[:flips]
            fl = base.unsqueeze(0).repeat(flips, 1)
            ar = torch.arange(flips, device=X.device)
            fl[ar, top] = 1.0 - base[top]
            rows.append(fl)
        if n_random:
            rows.append(_random_rows(base, dive_idx, n_random, ball, seed,
                                     round_index))
        rows.append(torch.stack([X.amax(dim=0), X.amin(dim=0)]))
        # bound rows: max/min commitment on the dive slots
        rows.append(torch.stack(
            [torch.where(dive_mask, ub_row, cons),
             torch.where(dive_mask, lb_row, cons)]))
        pool = torch.cat(rows)
    # integral snap on EVERY integer slot
    return torch.where(int_mask.unsqueeze(0), torch.round(pool), pool)


def build_pool(X, prob, dive_mask, integer_mask, lb_row=None, ub_row=None,
               *, thresholds=(0.3, 0.5, 0.7), flips=8, n_random=4, ball=4,
               seed=42, round_index=0, random_only=False, device=None):
    """(P, K) candidate pool (an f64 tensor) from the hub's (S, K)
    nonant block; see ``_build_pool`` for the row anatomy. Host
    wrapper: it clamps flips/ball to the dive-slot count (random rows
    need dive slots at all). Returns None for a ``random_only`` build
    with no dive slots — there is no neighborhood to vary, so the
    caller skips the round. ``device``: where the pool is built
    (default: X's device for a tensor, else the CPU)."""
    dive_mask = np.asarray(dive_mask, bool)
    n_dive = int(dive_mask.sum())
    flips_eff = min(int(flips), n_dive)
    n_rand_eff = int(n_random) if n_dive else 0
    ball_eff = max(1, min(int(ball), n_dive)) if n_dive else 1
    if random_only and n_dive == 0:
        return None
    dive_idx = np.flatnonzero(dive_mask) if n_dive \
        else np.zeros(1, np.int64)          # placeholder, never selected
    if device is None:
        device = X.device if isinstance(X, torch.Tensor) else "cpu"

    def t(a, dtype=torch.float64):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    K = X.shape[-1]
    lb_row = np.zeros(K) if lb_row is None else lb_row
    ub_row = np.ones(K) if ub_row is None else ub_row
    return _build_pool(
        t(X), t(prob), t(dive_mask, torch.bool),
        t(np.asarray(integer_mask, bool), torch.bool),
        t(dive_idx, torch.long), t(lb_row), t(ub_row), seed, round_index,
        thresholds=tuple(float(v) for v in thresholds), flips=flips_eff,
        ball=ball_eff, n_random=n_rand_eff, random_only=bool(random_only))


def pool_verdict(obj_rows, pri_res, pri_rel, prob, live, feas_tol, *, P, S):
    """Fused feasibility screen + Eobjective over the (P*S,) solved
    rows -> a (2, P) verdict [expected objective; all-scenarios-feasible
    flag]. A row passes on EITHER the absolute or the relative primal
    residual; rows of zero-probability pad scenarios (``live`` False)
    are exempt. ONE host read of the result is the round's single
    device-to-host copy."""
    feas = (pri_res <= feas_tol) | (pri_rel <= feas_tol)
    feas = feas.reshape(P, S) | ~live.unsqueeze(0)
    eobj = obj_rows.reshape(P, S) @ prob
    return torch.stack([eobj, feas.all(dim=1).to(eobj.dtype)])
