"""L-shaped method (Benders decomposition) for two-stage problems (the
port of mpisppy_tpu/core/lshaped.py).

The reference (ref. mpisppy/opt/lshaped.py:22-676) builds a Pyomo
master on rank 0 from scenario #1's first stage, adds per-scenario
``eta`` epigraph variables and iterates: master solve, broadcast x,
cut generation from subproblem duals, append cuts. Minimization only,
two-stage only.

Here:
- the master is an LP over [x_first (K), eta (S)] with a fixed-shape
  cut buffer (unfilled slots are (-inf, inf) rows), kept as host numpy
  and solved exactly by HiGHS on the host; the rows go to HiGHS as a
  ``scipy.sparse`` matrix (the same LP: at the reference UC scale the
  dense stack would be ~1.9 GB per call);
- the subproblem duals come from ONE batched solve with every nonant
  pinned at the master's x (``solve_loop(fixed=True)``, the eq-boosted
  pinned factorization). On the ``cuda`` backend that solve runs
  through the hand-written ADMM block (``ops/kernels.kernel_solve``);
- the cuts are certified: ``ops.qp_solver.benders_cut`` builds an affine
  minorant of each scenario's value function from the (possibly
  inexact) duals, so a cut's validity never depends on the solve
  tolerance, and the outer bound is the master's optimum;
- the master x doubles as an incumbent candidate every iteration.

Requires relatively complete recourse (no feasibility cuts; the
reference relies on valid eta bounds and optimality cuts the same way,
ref. lshaped.py:379-505).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .. import global_toc
from ..ops.qp_solver import benders_cut, cut_dual_selection
from ..utils.runtime import to_host
from .ph import PHBase


class LShapedMethod(PHBase):
    def __init__(self, batch, options=None, rho_setter=None, extensions=None,
                 converger=None, dtype=None, device=None, mesh=None):
        super().__init__(batch, options, rho_setter, extensions, converger,
                         dtype, device=device, mesh=mesh)
        if batch.tree.num_stages != 2:
            raise ValueError("LShapedMethod is two-stage only "
                             "(ref. opt/lshaped.py:439-442)")
        opts = self.options
        self.max_lshaped_iter = int(opts.get("max_iter", 50))
        self.lshaped_tol = float(opts.get("tol", 1e-7))
        self.cut_slots = int(opts.get("cuts_per_scenario", 24))
        self._LShaped_bound = None
        # per-iteration host seconds: the master (HiGHS), the pinned cut
        # solve (block + finisher) and the cut build
        self.lshaped_timing = []
        self._build_master_template()

    # ---- master construction (ref. lshaped.py:143-309) ----
    def _build_master_template(self):
        b = self.batch
        S, K = b.S, b.K
        n = b.n
        idx = np.asarray(b.nonant_idx)
        prob = np.asarray(b.prob, dtype=np.float64)

        # scenarios carried IN the master with their full second stage
        # (no eta, no cuts): the reference's
        # _create_master_with_scenarios (ref. lshaped.py:225-309)
        ms = sorted({int(s) for s in
                     self.options.get("master_scenarios", ())})
        if any(s < 0 or s >= S for s in ms):
            raise ValueError(f"master_scenarios out of range 0..{S - 1}")
        self._master_scens = ms
        self._eta_scens = [s for s in range(S) if s not in ms]
        Se = len(self._eta_scens)

        # first-stage rows: support entirely inside the nonant columns,
        # taken from scenario 0 as the reference takes scenario #1
        # (ref. lshaped.py:143 _create_master_no_scenarios)
        A0 = np.asarray(b.A_of(0))
        nonant_set = np.zeros(n, bool)
        nonant_set[idx] = True
        local_cols = np.flatnonzero(~nonant_set)
        nloc = len(local_cols)
        support = np.abs(A0) > 1e-12
        first_rows = np.flatnonzero(~support[:, ~nonant_set].any(axis=1)
                                    & support.any(axis=1))
        del support
        self._first_rows = first_rows
        m1 = len(first_rows)
        C = self.cut_slots
        m = b.m
        # columns: [x_first (K), eta per eta-scenario (Se),
        #           full local block per master scenario (nloc each)]
        nM = K + Se + len(ms) * nloc
        mM = m1 + Se * C + len(ms) * m

        A = np.zeros((mM, nM))
        l = np.full(mM, -np.inf)
        u = np.full(mM, np.inf)
        A[:m1, :K] = A0[np.ix_(first_rows, idx)]
        l[:m1] = np.asarray(b.l[0])[first_rows]
        u[:m1] = np.asarray(b.u[0])[first_rows]
        # cut slot rows: eta_s - g'x >= const (g, const filled per round)
        for si in range(Se):
            A[m1 + si * C: m1 + (si + 1) * C, K + si] = 1.0
        # full constraint blocks of the in-master scenarios
        for mi, s in enumerate(ms):
            rows = slice(m1 + Se * C + mi * m, m1 + Se * C + (mi + 1) * m)
            cols = slice(K + Se + mi * nloc, K + Se + (mi + 1) * nloc)
            A_s = np.asarray(b.A_of(s))
            A[rows, :K] = A_s[:, idx]
            A[rows, cols] = A_s[:, local_cols]
            l[rows] = np.asarray(b.l[s])
            u[rows] = np.asarray(b.u[s])

        lbx = np.asarray(b.lb)[:, idx].max(axis=0)
        ubx = np.asarray(b.ub)[:, idx].min(axis=0)
        lbv = [lbx, np.full(Se, -np.inf)]
        ubv = [ubx, np.full(Se, np.inf)]
        q = [np.zeros(K), prob[self._eta_scens]]
        for s in ms:
            lbv.append(np.asarray(b.lb[s])[local_cols])
            ubv.append(np.asarray(b.ub[s])[local_cols])
            q.append(prob[s] * np.asarray(b.c[s])[local_cols])
            # the in-master scenario's nonant-column costs ride on x
            q[0] = q[0] + prob[s] * np.asarray(b.c[s])[idx]
        self._mA = A
        self._ml = l
        self._mu = u
        self._m1 = m1
        self._lb_master = np.concatenate(lbv)
        self._ub_master = np.concatenate(ubv)
        self._q_master = np.concatenate(q)
        self._obj_const = float(sum(prob[s] * float(np.asarray(b.c0)[s])
                                    for s in ms))
        self._slots_filled = np.zeros(Se, dtype=np.int64)
        self._last_master_x = None
        # (rounded point, pinned state) of the last cut solve
        self._last_cut_solve = None
        self._cut_round = 0

    def set_eta_bounds(self):
        """Valid per-scenario eta lower bounds from one batched solve
        with x1 free: min_x f_s(x) <= V_s(b) for every b (ref.
        lshaped.py:335-350 set_eta_bounds). The bounds are the solve's
        certified dual objectives."""
        self.unfix_nonants()
        self.solve_loop(w_on=False, prox_on=False, update=False)
        eta_lb = to_host(self._last_dual_obj, np.float64)
        eta_lb = np.where(np.isfinite(eta_lb), eta_lb,
                          float(self.options.get("valid_eta_lb", -1e9)))
        K = self.batch.K
        Se = len(self._eta_scens)
        self._lb_master[K:K + Se] = eta_lb[self._eta_scens]

    def add_cuts(self, const, g_nonant):
        """Write this round's cuts into the slot buffer with slack-aware
        eviction: fill free slots first; once a scenario's slots are
        full, evict its loosest cut at the last master optimum, so a
        binding cut is never the one dropped."""
        K = self.batch.K
        C = self.cut_slots
        x_last = self._last_master_x
        for si, s in enumerate(self._eta_scens):
            base = self._m1 + si * C
            if self._slots_filled[si] < C:
                slot = int(self._slots_filled[si])
                self._slots_filled[si] += 1
            elif x_last is not None:
                rows = self._mA[base:base + C]
                slack = rows @ x_last - self._ml[base:base + C]
                slot = int(np.argmax(slack))
            else:
                slot = self._cut_round % C
            r = base + slot
            self._mA[r, :] = 0.0
            self._mA[r, :K] = -g_nonant[s]
            self._mA[r, K + si] = 1.0
            self._ml[r] = const[s]
            self._mu[r] = np.inf
        self._cut_round += 1

    def solve_master(self):
        """Exact host master LP solve (HiGHS).

        The master is a small sequential LP, degenerate with nearly
        parallel cut rows: the batched device solver is the wrong tool
        for it, and the reference also solves it on rank 0 (ref.
        lshaped.py:600-610). The returned LB is the master optimum, a
        valid outer bound because every cut is a certified minorant and
        the in-master scenario blocks are exact."""
        from scipy import sparse
        from scipy.optimize import linprog

        A = sparse.csr_matrix(self._mA)
        l, u = self._ml, self._mu
        rows_u = np.flatnonzero(np.isfinite(u))
        rows_l = np.flatnonzero(np.isfinite(l))
        A_ub = sparse.vstack([A[rows_u], -A[rows_l]]).tocsr()
        b_ub = np.concatenate([u[rows_u], -l[rows_l]])
        bounds = [(lo if np.isfinite(lo) else None,
                   hi if np.isfinite(hi) else None)
                  for lo, hi in zip(self._lb_master, self._ub_master)]
        res = linprog(self._q_master, A_ub=A_ub, b_ub=b_ub, bounds=bounds,
                      method="highs")
        if res.status != 0:
            raise RuntimeError(f"L-shaped master solve failed: {res.message}")
        K = self.batch.K
        Se = len(self._eta_scens)
        self._last_master_x = res.x
        return res.x[:K], res.x[K:K + Se], float(res.fun) + self._obj_const

    def generate_cuts(self, xf):
        """One batched subproblem solve at x1 = xf -> S certified cuts
        and the incumbent value (ref. lshaped.py:639 generate_cut).
        Returns (const (S,), g_nonant (S, K), ub or None)."""
        b = self.batch
        # round integer nonants ONCE and use the same point for the
        # solve, the ub and the cut, so all three describe one
        # (integer-feasible) first stage
        xf = self.round_nonants(xf)
        # the pinned solve must NOT warm-start from the previous master
        # point's iterates: a fully pinned LP is dual-degenerate along
        # the pinned columns (the bound duals have free rays), and
        # warm-started duals drift without bound across successive
        # points while the residuals stay tiny (measured on farmer in
        # the JAX package: yA max 3e3 -> 2e10 over four cut rounds, cut
        # constants reaching -inf, the master LB frozen at the
        # wait-and-see bound). Dropping the cached state, the chunked
        # mode's per-chunk states too, rebuilds it cold from a clean
        # transplant of the prox-off mode (_ensure_state).
        # At the SAME point, after a feasible solve, the solve continues
        # from its own state: when a weak cut (inexact duals) leaves the
        # master where it was, the cold rebuild would return the same
        # cut and stop the loop with the epigraph still loose.
        key = ("fixed", False)
        last = self._last_cut_solve
        if last is None or not np.array_equal(last[0], xf) \
                or self._qp_states.get(key) is not last[1]:
            self._qp_states.pop(key, None)
            self._chunk_states.pop(key, None)
        self.fix_nonants(xf)
        try:
            t0 = _time.perf_counter()
            # the polish keeps the deepest cut's duals, not the best
            # bound's (ops/qp_solver.cut_dual_selection)
            with cut_dual_selection():
                self.solve_loop(w_on=False, prox_on=False, update=False,
                                fixed=True)
            tol = float(self.options.get("xhat_feas_tol", 1e-4))
            st = self._qp_states[key]
            pri = to_host(st.pri_res)
            rel = to_host(st.pri_rel)
            feasible = bool(np.all((pri <= tol) | (rel <= tol)))
            # only a solve that met the feasibility test is continued
            # (an infeasible point's iterates diverge, as in
            # calculate_incumbent)
            self._last_cut_solve = (xf, st) if feasible else None
            ub = self.Eobjective_value() if feasible else None
            t1 = _time.perf_counter()
            # the pinned-box data the step used, for the duals
            d0 = self._data_with_prox(False)
            idx = self.nonant_idx
            fixed = torch.as_tensor(xf, dtype=self.dtype).to(
                self.device).expand(b.S, b.K)
            d = d0._replace(lb=d0.lb.index_copy(1, idx, fixed),
                            ub=d0.ub.index_copy(1, idx, fixed))
            pmask = torch.zeros(b.n, dtype=torch.bool, device=self.device)
            pmask[idx] = True
            b0 = torch.zeros((b.S, b.n), dtype=self.dtype,
                             device=self.device).index_copy(1, idx, fixed)
            const, g = benders_cut(d, self.c, self.c0, self.yA, self.yB,
                                   pmask, b0)
            g_nonant = to_host(g[:, idx], np.float64)
            const = to_host(const, np.float64)
            self._cut_timing = {"cut_solve_s": t1 - t0,
                                "cut_build_s": _time.perf_counter() - t1,
                                "feasible": feasible}
            return const, g_nonant, ub
        finally:
            self.unfix_nonants()

    # ---- the driver loop (ref. lshaped.py:507-676 lshaped_algorithm) ----
    def lshaped_algorithm(self, finalize=True):
        verbose = self.verbose
        self.set_eta_bounds()
        best_ub = np.inf
        best_xf = None
        self._iter = 0
        for it in range(1, self.max_lshaped_iter + 1):
            self._iter = it
            t0 = _time.perf_counter()
            xf, eta, lb = self.solve_master()
            t_master = _time.perf_counter() - t0
            if self._LShaped_bound is None or lb > self._LShaped_bound:
                self._LShaped_bound = lb
            const, g_nonant, ub = self.generate_cuts(xf)
            self._master_xf = xf
            if ub is not None and ub < best_ub:
                best_ub, best_xf = ub, xf.copy()
                self.best_ub, self.best_xf = best_ub, best_xf
            self.add_cuts(const, g_nonant)
            self.lshaped_timing.append(
                {"iter": it, "master_s": t_master, **self._cut_timing,
                 "lb": self._LShaped_bound, "ub": best_ub})
            gap = best_ub - self._LShaped_bound
            if verbose:
                global_toc(f"L-shaped iter {it}: LB={self._LShaped_bound:.4f}"
                           f" UB={best_ub:.4f} gap={gap:.3e}")
            if self.spcomm is not None:
                self.spcomm.sync(send_nonants=True)
                if self.spcomm.is_converged():
                    break
            # stop when the epigraph is tight: the master's eta matches
            # V(x) (in-master scenarios carry no eta and are exact)
            if not self._eta_scens:
                break
            cut_val = (const + np.sum(g_nonant * xf[None, :],
                                      axis=1))[self._eta_scens]
            viol = np.max(cut_val - eta)
            # scale by the incumbent when one exists; best_ub is inf
            # until a feasible pass, and inf*tol would stop at once
            scale = (max(1.0, abs(best_ub)) if np.isfinite(best_ub)
                     else max(1.0, abs(self._LShaped_bound)))
            if viol <= self.lshaped_tol * scale:
                global_toc(f"L-shaped converged at iter {it}", verbose)
                break
        self.best_ub = best_ub
        self.best_xf = best_xf
        if finalize:
            return self._LShaped_bound, best_ub, best_xf
        return self._LShaped_bound

    def _hub_nonants(self):
        """The master x broadcast over scenarios for cylinder traffic."""
        S, K = self.batch.S, self.batch.K
        xf = getattr(self, "_master_xf", None)
        if xf is None:
            return torch.zeros((S, K), dtype=self.dtype, device=self.device)
        return torch.as_tensor(xf, dtype=self.dtype).to(
            self.device).expand(S, K)
