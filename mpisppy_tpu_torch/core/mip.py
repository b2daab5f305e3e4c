"""Batched fix-and-dive: integer-feasible solutions from the LP/QP kernel.

The reference solves every subproblem to MIP optimality with a commercial
branch-and-bound solver (ref. mpisppy/phbase.py:1304-1362); its headline
results are MIP gaps (BASELINE.md). A full B&B is hostile to the TPU
execution model (data-dependent tree search), but PH-style algorithms only
need integer feasibility in two places:

  1. incumbent evaluation (x̂ spokes / XhatTryer, ref. utils/xhat_tryer.py)
     — the nonants are already fixed at a rounded x̂; only the REMAINING
     integer columns (second-stage integers) need integral values;
  2. direct EF solves on integer models (ref. opt/ef.py:61 +
     tests/test_ef_ph.py:149-150's sizes assertions).

Both are served by a batched DIVE: solve the relaxation, pin every integer
column that is already (near-)integral at its rounded value, pin the most
fractional column per scenario at its rounded value, re-solve warm-started,
repeat. All scenarios dive simultaneously — each round is one batched
kernel call, and column pinning is a pure lb/ub edit (the ADMM handles
boxes natively, no refactorization). This matches the intent of the
reference's rounding heuristics (slam, xhat) while staying compiler-
friendly; it yields FEASIBLE (upper-bound) solutions, not proven-optimal
ones — outer bounds still come from the certified LP duals.

The port of the JAX package's core/mip.py: the device tensors are
torch's, pin selection stays host numpy (``_h``, utils.runtime.to_host,
reads a tensor back).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.qp_solver import (qp_solve_segmented, qp_objective,
                             _Ax, host_dense_A, support_touch)
from ..utils.runtime import to_host as _h


def _dive_once(factors, data, q, state, imask, round_offset,
               max_iter, eps, int_tol, max_rounds, polish_chunk,
               pin_frac=8, feas_tol=1e-4):
    """One batched dive with per-scenario rounding bias and staged
    rollback. Fractional pins target floor(x + round_offset_s) — 0.5 is
    nearest-rounding, ~1.0 is ceiling.

    Each round bulk-pins the near-integral columns plus up to
    ceil(cand/pin_frac) of the least-fractional remaining columns per
    scenario (confident pins early; BINARIES decide last — a big-M
    binary's LP value is a tiny meaningful fraction that would otherwise
    be pinned to 0 before its linked quantity settles). When a round's
    pins break a scenario's feasibility the scenario retries with a
    single pin, then with that pin flipped to the other integer; if both
    fail it stops pinning (dead) and the caller's repair passes take
    over. Pin selection is host-side numpy — each round syncs anyway for
    the stop check."""
    S, n = data.lb.shape
    dev, dt = data.lb.device, data.lb.dtype
    imask_h = _h(imask)
    off_h = _h(round_offset)
    lb0 = _h(data.lb)
    ub0 = _h(data.ub)
    lb, ub = lb0.copy(), ub0.copy()
    pinned = ~imask_h
    dead = np.zeros(S, bool)
    st = state
    eps_mid = max(eps, 1e-5)         # intermediate dives can be loose
    is_bin = (ub0 - lb0) <= 1.0 + 1e-9

    def solve(lb_, ub_, st_, tight=False):
        d = data._replace(lb=torch.as_tensor(lb_, dtype=dt, device=dev),
                          ub=torch.as_tensor(ub_, dtype=dt, device=dev))
        e = eps if tight else eps_mid
        # segmented: a dive round can run thousands of iterations, and
        # single long device executions trip accelerator watchdogs
        return qp_solve_segmented(factors, d, q, st_, max_iter=max_iter,
                                  eps_abs=e, eps_rel=e,
                                  polish_chunk=polish_chunk)

    def feas(st_):
        return _h((st_.pri_res <= 10 * feas_tol)
                  | (st_.pri_rel <= 10 * feas_tol))

    st, x, _, _ = solve(lb, ub, st)
    for _ in range(max_rounds):
        x_h = _h(x)
        live = imask_h & ~pinned & ~dead[:, None]
        frac = np.where(live, np.abs(x_h - np.round(x_h)), 0.0)
        if frac.max() <= int_tol:
            val = np.clip(np.round(x_h), lb0, ub0)
            lb[live] = val[live]
            ub[live] = val[live]
            pinned |= live
            break
        val_near = np.clip(np.round(x_h), lb0, ub0)
        val_bias = np.clip(np.floor(x_h + off_h[:, None]), lb0, ub0)
        # candidate order per scenario, fully vectorized (a per-scenario
        # Python loop here was the S=512 scaling wall, VERDICT r2): key
        # = fractionality + binary penalty (non-binaries pin first,
        # BINARIES decide last); non-candidates key to +inf so a stable
        # argsort reproduces the per-scenario candidate ordering exactly
        is_cand = frac > int_tol
        key = np.where(is_cand, frac + 10.0 * is_bin, np.inf)
        order = np.argsort(key, axis=1, kind="stable")    # (S, n) cols
        cand_counts = is_cand.sum(axis=1)

        # the flipped pin value: the other integer neighbour of the
        # fractional value — a value that was rounded down flips up and
        # vice versa (flipping relative to val_near would no-op at a
        # bound, e.g. a 0-pinned binary clipping right back to 0); when
        # the preferred neighbour leaves the box (a loose solve can
        # leave x outside it), go the other way
        xr = np.clip(x_h, lb0, ub0)
        v_alt = np.where(val_bias <= xr, val_bias + 1.0, val_bias - 1.0)
        v_alt = np.where(v_alt > ub0, val_bias - 1.0,
                         np.where(v_alt < lb0, val_bias + 1.0, v_alt))
        val_flip = np.clip(v_alt, lb0, ub0)

        def attempt(k_of_s, flip):
            """Bounds with near-integral bulk pins + the first k_of_s[s]
            ordered fractional pins (flipped where `flip`)."""
            pin = live & (frac <= int_tol)
            k = np.where(dead, 0, np.minimum(k_of_s, cand_counts))
            in_prefix = np.arange(n)[None, :] < k[:, None]
            take = np.zeros((S, n), bool)
            np.put_along_axis(take, order, in_prefix, axis=1)
            take &= is_cand
            val = np.where(take & flip[:, None], val_flip,
                           np.where(take, val_bias, val_near))
            pin = pin | take
            lb_t, ub_t = lb.copy(), ub.copy()
            lb_t[pin] = val[pin]
            ub_t[pin] = val[pin]
            return pin, lb_t, ub_t

        k_full = np.where(cand_counts > 0,
                          np.maximum(1, -(-cand_counts // pin_frac)), 0)
        no_flip = np.zeros(S, bool)
        pinT, lbT, ubT = attempt(k_full, no_flip)
        stT, xT, _, _ = solve(lbT, ubT, st)
        ok = feas(stT) | dead          # dead rows keep "ok" (no change)
        stages = [(pinT, lbT, ubT, ok)]
        if not ok.all():
            # stage B: single pin for the failed scenarios
            kB = np.where(ok, k_full, np.minimum(k_full, 1))
            pinB, lbB, ubB = attempt(kB, no_flip)
            lbm = np.where(ok[:, None], lbT, lbB)
            ubm = np.where(ok[:, None], ubT, ubB)
            stB, xB, _, _ = solve(lbm, ubm, st)
            okB = feas(stB) | ok
            stages.append((pinB, lbB, ubB, okB & ~ok))
            if not okB.all():
                # stage C: flip that single pin
                pinC, lbC, ubC = attempt(kB, ~okB)
                lbm = np.where(okB[:, None], lbm, lbC)
                ubm = np.where(okB[:, None], ubm, ubC)
                stC, xC, _, _ = solve(lbm, ubm, st)
                okC = feas(stC) | okB
                stages.append((pinC, lbC, ubC, okC & ~okB))
                dead |= ~okC
            # merge: each scenario takes the bounds of the stage that
            # fixed it; dead scenarios keep the pre-round bounds
            for pin_s, lb_s, ub_s, sel in stages:
                m = sel[:, None]
                lb = np.where(m, lb_s, lb)
                ub = np.where(m, ub_s, ub)
                pinned |= pin_s & m
            # one consistent solve on the merged bounds
            st, x, _, _ = solve(lb, ub, st)
        else:
            lb, ub = lbT, ubT
            pinned |= pinT
            x, st = xT, stT
        if (pinned | dead[:, None] | ~imask_h).all():
            break
    # final TIGHT solve on the end bounds
    st, x, _, _ = solve(lb, ub, st, tight=True)
    return x, st, lb, ub, pinned


def dive_integers(factors, data, q, c0, state, integer_mask,
                  max_iter=2000, eps=1e-7, int_tol=1e-5, feas_tol=1e-4,
                  max_rounds=None, polish_chunk=0, pin_frac=8):
    """Drive all scenarios to integer feasibility on ``integer_mask``.

    Returns (x, obj, feasible, state):
      x (S, n) with integer columns at integral values where feasible,
      obj (S,) primal objective at x,
      feasible (S,) bool — True when the final pinned solve's primal
        residual passes ``feas_tol`` (absolute or relative) AND every
        integer column is integral to ``int_tol``.

    Two passes: nearest-rounding first; scenarios whose pinned problem
    came out infeasible (typically a covering row broken by a
    rounded-DOWN quantity) retry with ceiling-biased rounding. The loop is
    host-driven (a handful of rounds; each round is one jitted batched
    solve) because the pin set is data-dependent; the per-round work is
    all on-device.
    """
    S, n = data.lb.shape
    dev = data.lb.device
    imask = torch.as_tensor(_h(integer_mask), dtype=torch.bool,
                            device=dev).expand(S, n)
    rounds = int(max_rounds) if max_rounds is not None else \
        int(_h(integer_mask).sum()) + 2

    def check(x, st):
        frac_fin = torch.amax(torch.where(imask, (x - torch.round(x)).abs(),
                                          0.0), dim=1)
        # the dive PINS integer columns (lb = ub at the chosen integer),
        # so a column's distance from its integer is bounded by the box
        # residual the feasibility test already allows — gating
        # integrality tighter than feas_tol would re-reject solves for
        # the solver accuracy just accepted (df32's ~1e-4..1e-3 floor
        # failed every UC dive through a 1e-4 integrality gate)
        return ((st.pri_res <= feas_tol) | (st.pri_rel <= feas_tol)) \
            & (frac_fin <= max(10 * int_tol, feas_tol))

    off = np.full((S,), 0.5)
    x, st, lb, ub, pinned = _dive_once(factors, data, q, state, imask, off,
                                       max_iter, eps, int_tol, rounds,
                                       polish_chunk, pin_frac=pin_frac,
                                       feas_tol=feas_tol)
    feasible = check(x, st)

    if not bool(feasible.all()):
        # TARGETED repair: unpin only the integer columns supporting
        # violated rows and re-dive them ceiling-biased (the standard
        # failure is a covering row broken by a rounded-DOWN quantity);
        # everything else keeps its nearest-rounded pin
        Ax = _h(_Ax(data.A, x))
        l_h, u_h = _h(data.l), _h(data.u)
        # row scale from the FINITE bounds only (an infinite side must not
        # blow the tolerance to inf and mask violations of the other side)
        l_fin = np.where(np.isfinite(l_h), np.abs(l_h), 0.0)
        u_fin = np.where(np.isfinite(u_h), np.abs(u_h), 0.0)
        tol_row = feas_tol * (1.0 + np.maximum(l_fin, u_fin))
        viol = (Ax < np.where(np.isfinite(l_h), l_h, -np.inf) - tol_row) \
            | (Ax > np.where(np.isfinite(u_h), u_h, np.inf) + tol_row)
        # column-touch through A's support, computed ON DEVICE: the big
        # representations (SplitMatrix / ScaledView) must not be pulled
        # dense to host (GB-scale d2h on tunneled links)
        touch = _h(support_touch(data.A, torch.as_tensor(viol,
                                                         device=dev)))
        bad = ~_h(feasible)
        unpin = (touch > 0.5) & _h(imask) & bad[:, None]
        lb2, ub2 = lb.copy(), ub.copy()
        lb2[unpin] = _h(data.lb)[unpin]
        ub2[unpin] = _h(data.ub)[unpin]
        d2 = data._replace(
            lb=torch.as_tensor(lb2, dtype=data.lb.dtype, device=dev),
            ub=torch.as_tensor(ub2, dtype=data.ub.dtype, device=dev))
        off2 = np.where(_h(feasible), 0.5, 1.0 - 1e-9)
        # only the unpinned columns dive; all other pins ride in lb2/ub2
        x2, st2, *_ = _dive_once(factors, d2, q, st, unpin,
                                 off2, max_iter, eps, int_tol, rounds,
                                 polish_chunk, pin_frac=pin_frac,
                                 feas_tol=feas_tol)
        feas2 = check(x2, st2)
        take = (~feasible & feas2)[:, None]
        x = torch.where(take, x2, x)
        feasible = feasible | feas2
        st = st2

    if not bool(feasible.all()):
        # blanket ceiling fallback for scenarios the repair didn't fix
        off3 = np.where(_h(feasible), 0.5, 1.0 - 1e-9)
        x3, st3, *_ = _dive_once(factors, data, q, state, imask, off3,
                                 max_iter, eps, int_tol, rounds,
                                 polish_chunk, pin_frac=pin_frac,
                                 feas_tol=feas_tol)
        feas3 = check(x3, st3)
        take = (~feasible & feas3)[:, None]
        x = torch.where(take, x3, x)
        feasible = feasible | feas3
        st = st3

    x = torch.where(imask, torch.round(x), x)   # snap for reporting
    obj = qp_objective(data, q, c0, x)
    return x, obj, feasible, st


def milp_solve(data, q, c0, integer_mask, time_limit=120.0, mip_gap=None):
    """Host-side exact MIP solve per scenario via scipy's HiGHS
    (scipy.optimize.milp) — the analog of the reference handing a
    monolithic EF to a rented B&B solver (ref. mpisppy/opt/ef.py:61,
    phbase.py:1307 SolverFactory). Sequential over scenarios, so meant
    for the SMALL host-side problems (the EF utility, test oracles); the
    batched device path is dive_integers.

    Returns (x (S, n), obj (S,), feasible (S,))."""
    from scipy.optimize import milp, LinearConstraint, Bounds

    A = host_dense_A(data.A)
    S = data.l.shape[0]
    n = data.lb.shape[-1]
    P = np.broadcast_to(_h(data.P_diag), (S, n))
    if np.abs(P).max() > 0:
        raise ValueError("milp_solve handles linear objectives only")
    q_h = np.broadcast_to(_h(q), (S, n))
    c0_h = np.broadcast_to(_h(c0), (S,))
    integ = np.broadcast_to(_h(integer_mask).astype(bool), (S, n))
    l_h, u_h = _h(data.l), _h(data.u)
    lb_h, ub_h = _h(data.lb), _h(data.ub)
    xs = np.zeros((S, n))
    objs = np.full(S, np.inf)
    feas = np.zeros(S, bool)
    opts = {"time_limit": float(time_limit)}
    if mip_gap is not None:
        opts["mip_rel_gap"] = float(mip_gap)
    from scipy import sparse
    for s in range(S):
        A_s = A if A.ndim == 2 else A[s]
        # EF-scale matrices are block-sparse; HiGHS takes CSR directly
        # and a dense handoff dominates construction time at that size
        A_s = sparse.csr_matrix(A_s)
        res = milp(q_h[s],
                   constraints=LinearConstraint(A_s, l_h[s], u_h[s]),
                   bounds=Bounds(lb_h[s], ub_h[s]),
                   integrality=integ[s].astype(int), options=opts)
        if res.x is not None:
            xs[s] = res.x
            objs[s] = res.fun + c0_h[s]
            feas[s] = res.status in (0, 1)   # optimal or time-limit incumbent
    return xs, objs, feas
