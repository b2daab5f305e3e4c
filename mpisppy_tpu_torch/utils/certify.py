"""Host-f64 SAFE-ROUNDING certification of device-derived dual bounds.

The device kernel's ``qp_dual_objective`` yields a lower bound that is
exact *in real arithmetic* for any dual vector, but its df32 evaluation
path (three f32 MXU passes accumulated in f64, ops/qp_solver.SplitMatrix)
carries ~1e-7-relative accumulation noise — enough that the printed
number is not *provably* below the true optimum. This module closes that
last gap on the host: given the raw row duals of a batched solve, it

 1. treats the (possibly f32-cast) dual vector as EXACT — any dual
    vector certifies a valid bound, so quantizing the duals costs
    tightness, never validity (the transfer-economy trick: pull (S, m)
    duals at half the bytes);
 2. projects them onto the dual-feasible cone in f64 (zeroing
    components that push on infinite bounds — always sign-infeasible
    there, and a different-but-valid dual choice);
 3. TIGHTENS infinite variable boxes by one sweep of activity-based
    implied bounds from the constraint rows (classic presolve: the UC
    capacity row p − pmax·u <= 0 caps the otherwise-unbounded p at
    pmax). Valid because the Lagrangian bound argument only needs a
    relaxation SET containing the feasible set — the implied box is
    one. Without this, the eps-level negative reduced costs that
    first-order duals leave on unbounded columns certify −inf;
 4. evaluates the Lagrangian dual value per scenario in f64 with
    *directed-rounding margins*: every float sum/product's worst-case
    rounding error (the standard gamma_k = k·u/(1−k·u) forward bound)
    is SUBTRACTED from the result, so the published value is provably
    <= the exact dual value, which is <= the true scenario optimum;
 5. charges the W off-manifold residual: the Lagrangian decomposition
    is an outer bound only when sum_s p_s W_s = 0 per (node, slot);
    after the f64 projection an eps-level residual delta remains, and
    the bound is debited |delta| x (tightest member box magnitude) per
    slot instead of assuming exact membership.

The margins are ~1e-13 relative on UC-class data — invisible tightness
cost for a bound that is certified end to end with no LP oracle call.
Linear objectives only (the standard host-certification eligibility;
quadratic models keep the device certificate).
"""

from __future__ import annotations

import numpy as np
from scipy import sparse as sparse_mod

# unit roundoff of IEEE double
_U = 0.5 * np.finfo(np.float64).eps


def _gamma(k):
    """Standard forward-error factor: |fl(sum of k products) − exact|
    <= gamma_k · sum|terms| (Higham, Accuracy and Stability, §3.1)."""
    ku = float(k) * _U
    return ku / (1.0 - ku)


def _boxmin_endpoint(r, lb, ub):
    """min_{x in [lb, ub]} r·x for a KNOWN r (elementwise): r·lb where
    r > 0 (−inf if lb = −inf), r·ub where r < 0 (−inf if ub = +inf),
    0 where r == 0."""
    out = np.zeros_like(r)
    pos = r > 0
    neg = r < 0
    out[pos] = r[pos] * lb[pos]
    out[neg] = r[neg] * ub[neg]
    return out


def _boxmin_certified(r, err, lb, ub):
    """Certified lower bound of min_x r_true·x over [lb, ub] given only
    |r_true − r| <= err. The box minimum is concave in r (a min of
    linear functions), so its minimum over the uncertainty interval is
    attained at an endpoint; one extra multiplication-rounding margin
    makes the float evaluation itself safe."""
    lo = np.minimum(_boxmin_endpoint(r - err, lb, ub),
                    _boxmin_endpoint(r + err, lb, ub))
    fin = np.isfinite(lo)
    lo[fin] -= _gamma(2) * np.abs(lo[fin])
    return lo


def implied_box_tightening(A_csr, l, u, lb, ub):
    """ONE sweep of activity-based implied bounds, restricted to the
    columns with an infinite box side — the presolve step that makes
    unbounded-column LPs certifiable (see the module docstring, step 3).

    For row i (l_i <= Σ A_ik x_k <= u_i) and column j with a = A_ij:
    x_j <= (u_i − minact_{k≠j}) / a when a > 0, and
    x_j <= (l_i − maxact_{k≠j}) / a when a < 0 (mirrored for lower
    bounds), usable only when every OTHER term's needed activity side
    is finite. Derived caps are inflated by the rounding envelope of
    their own evaluation, so the tightened box provably contains the
    feasible set. Returns (lb2, ub2) copies ((S, n))."""
    A = A_csr.tocsr()
    m, n = A.shape
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    l = np.asarray(l, np.float64)
    u = np.asarray(u, np.float64)
    lb2, ub2 = lb.copy(), ub.copy()
    pos = A.maximum(0).tocsr()
    neg = A.minimum(0).tocsr()
    ppat = (pos != 0).astype(np.float64)
    npat = (neg != 0).astype(np.float64)
    lbf = np.where(np.isfinite(lb), lb, 0.0)
    ubf = np.where(np.isfinite(ub), ub, 0.0)
    inf_lb = (~np.isfinite(lb)).astype(np.float64)
    inf_ub = (~np.isfinite(ub)).astype(np.float64)
    # (S, m) finite-side activities + per-row counts of infinite terms
    minact = pos.dot(lbf.T).T + neg.dot(ubf.T).T
    maxact = pos.dot(ubf.T).T + neg.dot(lbf.T).T
    cnt_min = ppat.dot(inf_lb.T).T + npat.dot(inf_ub.T).T
    cnt_max = ppat.dot(inf_ub.T).T + npat.dot(inf_lb.T).T
    # rounding envelope of the activity sums (per row, per scenario)
    absact = abs(A).dot(np.maximum(np.abs(lbf), np.abs(ubf)).T).T
    row_nnz = np.diff(A.indptr)
    A_csc = A.tocsc()
    cols_inf_ub = np.flatnonzero((~np.isfinite(ub)).any(axis=0))
    cols_inf_lb = np.flatnonzero((~np.isfinite(lb)).any(axis=0))

    def tighten(j, want_upper):
        best = np.full(lb.shape[0], np.inf if want_upper else -np.inf)
        for idx in range(A_csc.indptr[j], A_csc.indptr[j + 1]):
            i = A_csc.indices[idx]
            a = A_csc.data[idx]
            genv = _gamma(int(row_nnz[i]) + 4)
            if want_upper:
                if a > 0:
                    # own min-term of j used side lb (finite iff lb_j)
                    own_inf = inf_lb[:, j]
                    own = a * lbf[:, j]
                    ok = np.isfinite(u[:, i]) & (cnt_min[:, i] - own_inf
                                                 <= 0.5)
                    cand = (u[:, i] - (minact[:, i] - own)) / a
                else:
                    # a < 0 contributes a·lb to MAXact: own side is lb
                    own_inf = inf_lb[:, j]
                    own = a * lbf[:, j]
                    ok = np.isfinite(l[:, i]) & (cnt_max[:, i] - own_inf
                                                 <= 0.5)
                    cand = (l[:, i] - (maxact[:, i] - own)) / a
                env = genv * (np.abs(u[:, i] if a > 0 else l[:, i])
                              + absact[:, i] + np.abs(own)) / abs(a)
                cand = cand + env          # safe-side: inflate upward
                best = np.where(ok, np.minimum(best, cand), best)
            else:
                if a > 0:
                    own_inf = inf_ub[:, j]
                    own = a * ubf[:, j]
                    ok = np.isfinite(l[:, i]) & (cnt_max[:, i] - own_inf
                                                 <= 0.5)
                    cand = (l[:, i] - (maxact[:, i] - own)) / a
                else:
                    # a < 0 contributes a·ub to MINact: own side is ub
                    own_inf = inf_ub[:, j]
                    own = a * ubf[:, j]
                    ok = np.isfinite(u[:, i]) & (cnt_min[:, i] - own_inf
                                                 <= 0.5)
                    cand = (u[:, i] - (minact[:, i] - own)) / a
                env = genv * (np.abs(l[:, i] if a > 0 else u[:, i])
                              + absact[:, i] + np.abs(own)) / abs(a)
                cand = cand - env          # safe-side: deflate downward
                best = np.where(ok, np.maximum(best, cand), best)
        return best

    for j in cols_inf_ub:
        cap = tighten(j, want_upper=True)
        take = ~np.isfinite(ub2[:, j]) & np.isfinite(cap)
        ub2[take, j] = cap[take]
    for j in cols_inf_lb:
        cap = tighten(j, want_upper=False)
        take = ~np.isfinite(lb2[:, j]) & np.isfinite(cap)
        lb2[take, j] = cap[take]
    return lb2, ub2


class DualBoundCertifier:
    """Reusable host certifier for one scenario batch (shared-structure
    or per-scenario matrices). Build once per spoke/test; ``bound`` runs
    per refresh. See the module docstring for the guarantee."""

    def __init__(self, A, l, u, lb, ub, c, c0, prob, nonant_idx=None,
                 P_diag=None, w_stages=None, tighten_boxes=True):
        if P_diag is not None and np.abs(np.asarray(P_diag)).max() > 0:
            raise ValueError("host certification supports linear "
                             "objectives only")
        self.l = np.asarray(l, np.float64)
        self.u = np.asarray(u, np.float64)
        self.c = np.asarray(c, np.float64)
        self.c0 = np.asarray(c0, np.float64)
        self.prob = np.asarray(prob, np.float64)
        S = self.l.shape[0]
        if sparse_mod.issparse(A):
            self._As = [sparse_mod.csr_matrix(A)]
        else:
            A = np.asarray(A, np.float64)
            if A.ndim == 2:
                self._As = [sparse_mod.csr_matrix(A)]
            elif all(np.array_equal(A[s], A[0]) for s in range(1, S)):
                self._As = [sparse_mod.csr_matrix(A[0])]
            else:
                self._As = [sparse_mod.csr_matrix(A[s]) for s in range(S)]
        self.shared = len(self._As) == 1
        self._absAs = [abs(a) for a in self._As]
        lb = np.asarray(lb, np.float64)
        ub = np.asarray(ub, np.float64)
        if tighten_boxes and not (np.isfinite(lb).all()
                                  and np.isfinite(ub).all()):
            if self.shared:
                lb, ub = implied_box_tightening(self._As[0], self.l,
                                                self.u, lb, ub)
            else:
                parts = [implied_box_tightening(
                    self._As[s], self.l[s:s + 1], self.u[s:s + 1],
                    lb[s:s + 1], ub[s:s + 1]) for s in range(S)]
                lb = np.concatenate([p[0] for p in parts])
                ub = np.concatenate([p[1] for p in parts])
        self.lb, self.ub = lb, ub
        # max terms in any (AᵀyA + q)_j sum, + headroom for the q add
        # and the f64 construction of q = c + W itself
        kmax = max(int(np.diff(a.tocsc().indptr).max(initial=0))
                   for a in self._As)
        self._g_r = _gamma(kmax + 4)
        self.nonant_idx = None if nonant_idx is None \
            else np.asarray(nonant_idx)
        # (slice, membership (S, N)) per non-leaf stage, for the W
        # off-manifold residual margin
        self._w_stages = w_stages
        self._g_sup = _gamma(self._As[0].shape[0] + 4)
        self._g_col = _gamma(self._As[0].shape[1] + 4)

    @classmethod
    def from_batch(cls, batch):
        stages = []
        for t, sl in enumerate(batch.stage_slot_slices):
            B = np.asarray(batch.tree.membership(t + 1), np.float64)
            stages.append((sl, B))
        return cls(batch.A, batch.l, batch.u, batch.lb, batch.ub,
                   batch.c, batch.c0, batch.prob,
                   nonant_idx=batch.nonant_idx, P_diag=batch.P_diag,
                   w_stages=stages)

    # -- pieces --
    def _sanitize(self, y):
        """Project row duals onto the dual-feasible cone: a component
        pushing on an infinite bound is always sign-infeasible; zeroing
        it is a different (still valid) dual choice, not an
        approximation."""
        y = np.array(y, np.float64, copy=True)
        y[np.broadcast_to(np.isposinf(self.u), y.shape) & (y > 0)] = 0.0
        y[np.broadcast_to(np.isneginf(self.l), y.shape) & (y < 0)] = 0.0
        return y

    def _sup_rows_upper(self, y):
        """Certified UPPER bound on sup_{l<=z<=u} yᵀz per scenario
        (sanitized y ⇒ finite)."""
        yp = np.maximum(y, 0.0)
        ym = np.maximum(-y, 0.0)
        u_fin = np.where(np.isfinite(self.u), self.u, 0.0)
        l_fin = np.where(np.isfinite(self.l), self.l, 0.0)
        sup = np.sum(u_fin * yp - l_fin * ym, axis=1)
        mag = np.sum(np.abs(u_fin) * yp + np.abs(l_fin) * ym, axis=1)
        return sup + self._g_sup * mag

    def _w_manifold_margin(self, W):
        """Upper bound on the bound slip from W's off-manifold residual
        after f64 projection: sum over (node, slot) of |sum_{s in node}
        p_s W_sk| x (tightest member-box magnitude for that column).
        Returns +inf when a nonzero residual meets an unbounded column
        (cannot be certified) — callers fall back to the device value."""
        if W is None:
            return 0.0
        if self._w_stages is None or self.nonant_idx is None:
            return np.inf
        W = np.asarray(W, np.float64)
        total = 0.0
        for sl, B in self._w_stages:
            cols = self.nonant_idx[sl]
            # per-slot residual mass per node, + its own summation error
            pw = self.prob[:, None] * W[:, sl]
            num = B.T @ pw                                    # (N, k)
            num_abs = np.abs(num) \
                + _gamma(B.shape[0] + 2) * (np.abs(B).T @ np.abs(pw))
            # |z_node| <= min over member scenarios of max(|lb|,|ub|)
            mag = np.maximum(np.abs(self.lb[:, cols]),
                             np.abs(self.ub[:, cols]))       # (S, k)
            big = 1e300
            mag = np.where(np.isfinite(mag), mag, big)
            node_mag = np.full(num.shape, big)
            for node in range(B.shape[1]):
                members = np.flatnonzero(B[:, node] > 0)
                if members.size:
                    node_mag[node] = mag[members].min(axis=0)
            slip = num_abs * node_mag
            if np.any((num_abs > 0) & (node_mag >= big)):
                return np.inf
            total += float(np.sum(slip) * (1.0 + _gamma(num.size + 2)))
        return total

    def _repair_scale(self, r, err, q):
        """Per-scenario dual scale t in [0, 1] making every
        unbounded-direction reduced cost provably sign-feasible under
        the error envelope: for ub=+inf columns, q + t(r−q) >= err
        (mirrored for lb=−inf). t is taken safe-side (the envelope at
        t <= 1 is bounded by the envelope at 1). Scenarios with no
        violation keep t=1."""
        S = r.shape[0]
        t = np.ones(S)
        up_inf = np.broadcast_to(~np.isfinite(self.ub), r.shape)
        lo_inf = np.broadcast_to(~np.isfinite(self.lb), r.shape)
        # target 4·err of slack: the scaled reduced cost is RECOMPUTED
        # under its own (≤ err) envelope, so landing exactly at err
        # would leave zero certified margin
        slack = 4.0 * err
        with np.errstate(divide="ignore", invalid="ignore"):
            # ub=+inf columns need r >= err; violated where r < slack
            viol_u = up_inf & (r < slack)
            # q + t(r−q) >= slack ⇒ t <= (q − slack)/(q − r) (q > r here)
            tu = np.where(viol_u,
                          (q - slack) / np.maximum(q - r, 1e-300), 1.0)
            # lb=−inf columns need r <= −err; violated where r > −slack
            viol_l = lo_inf & (r > -slack)
            tl = np.where(viol_l,
                          (-q - slack) / np.maximum(r - q, 1e-300), 1.0)
        t = np.minimum(t, np.clip(np.nan_to_num(tu, nan=0.0), 0.0, 1.0)
                       .min(axis=1))
        t = np.minimum(t, np.clip(np.nan_to_num(tl, nan=0.0), 0.0, 1.0)
                       .min(axis=1))
        return t

    def _reduced_costs(self, yA, q):
        """(r, err_r): f64 reduced costs q + Aᵀy with their directed
        forward-error envelope, under either matrix layout."""
        if self.shared:
            A, absA = self._As[0], self._absAs[0]
            r = A.T.dot(yA.T).T + q
            err = self._g_r * (absA.T.dot(np.abs(yA).T).T + np.abs(q))
            return r, err
        r = np.empty_like(q)
        err = np.empty_like(q)
        for s, (A, absA) in enumerate(zip(self._As, self._absAs)):
            r[s] = A.T.dot(yA[s]) + q[s]
            err[s] = self._g_r * (absA.T.dot(np.abs(yA[s])) + np.abs(q[s]))
        return r, err

    # -- public API --
    def scenario_bounds(self, yA, W=None):
        """Per-scenario certified lower values of
        min (c_s + W on nonant slots)·x over each scenario's feasible
        set, from row duals ``yA`` ((S, m), any precision — treated as
        exact). −inf rows mean "uncertifiable there" (an unbounded
        column whose reduced-cost sign the margins cannot pin, and no
        implied cap either)."""
        yA = self._sanitize(np.asarray(yA, np.float64))
        q = self.c.copy()
        if W is not None:
            if self.nonant_idx is None:
                raise ValueError("W terms need a nonant index map")
            q[:, self.nonant_idx] += np.asarray(W, np.float64)
        r, err_r = self._reduced_costs(yA, q)
        # DUAL SCALING repair for genuinely unbounded columns (no
        # implied cap): first-order duals leave eps-level wrong-sign
        # reduced costs there, which certify −inf. r(t) = q + t·(r − q)
        # is the reduced cost of the scaled dual t·yA — still a valid
        # dual vector for every t — and at t slightly below 1 the
        # wrong-sign components provably clear zero (their q side is
        # sign-correct, or the LP really is unbounded that direction).
        # Cost: ~(1−t) relative tightness, i.e. ~the violation itself.
        t = self._repair_scale(r, err_r, q)
        scaled = t < 1.0
        if np.any(scaled):
            yA = np.where(scaled[:, None], t[:, None] * yA, yA)
            r, err_r = self._reduced_costs(yA, q)
        contrib = _boxmin_certified(r, err_r, self.lb, self.ub)
        fin = np.isfinite(contrib)
        ssum = np.where(fin, contrib, 0.0).sum(axis=1)
        smag = np.abs(np.where(fin, contrib, 0.0)).sum(axis=1)
        vals = ssum - self._g_col * smag - self._sup_rows_upper(yA) \
            + self.c0
        vals -= _gamma(8) * np.abs(vals)
        vals[~fin.all(axis=1)] = -np.inf
        return vals

    def bound(self, yA, W=None):
        """Certified Lagrangian outer bound E_p[scenario value] from row
        duals ``yA`` at (projected) ``W``. Returns (bound, vals); the
        bound is −inf when any live scenario is uncertifiable or the W
        residual cannot be charged."""
        vals = self.scenario_bounds(yA, W)
        live = np.flatnonzero(self.prob > 0.0)
        if not np.isfinite(vals[live]).all():
            return -np.inf, vals
        margin = self._w_manifold_margin(W)
        if not np.isfinite(margin):
            return -np.inf, vals
        pv = self.prob[live] * vals[live]
        total = float(pv.sum() - _gamma(live.size + 4) * np.abs(pv).sum()
                      - margin)
        return total, vals
