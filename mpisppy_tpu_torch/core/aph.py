"""APH: Asynchronous Projective Hedging (the port of the JAX package's
core/aph.py; Algorithm 2 of the APH paper, ref. mpisppy/opt/aph.py).

The math per iteration (notation as in the reference):
  y_s   = W_s + ρ(x_s − z_s)             (dispatched scenarios only;
                                          y ≡ 0 at iter 1)
  x̄,x̄²,ȳ = probability-weighted per-node means (membership matmuls)
  u_s   = x_s − x̄;  v = ȳ
  τ     = Σ_s p_s (‖u_s‖² + ‖ȳ‖²/γ)
  φ     = Σ_s p_s ⟨z_s − x_s, W_s − y_s⟩
  θ     = ν φ/τ  if τ>0 and φ>0 else 0
  W_s  += θ u_s;   z_s += θ ȳ/γ          (z := x̄ at iter 1)
  conv  = ‖u‖_p/‖W‖_p + ‖v‖_p/‖z‖_p
  dispatch: the ⌈frac·S⌉ most-negative post-step φ_s, tie-broken by least
  recently dispatched; the subproblem is f_s(x) + W·x + (ρ/2)‖x − z‖²,
  prox against z, not x̄ (ref. aph.py:866-883).

On one device the reference's listener and side gig are membership
matmuls, so the asynchrony model is carried by PARTIAL DISPATCH:
undispatched scenarios keep stale x (and lagged W/z with
``aph_use_lag``). The selection runs on the device (ops/dispatch), and
the iteration's whole host traffic is ONE packed gate row
(``aph.gate_syncs``). On the chunked loop with a shared A
(``_dispatch_capable``) a partial pass solves only the dispatched
scenarios (``solve_loop(dispatch=ids)``: ⌈scnt/chunk⌉ block calls
instead of ⌈S/chunk⌉); otherwise every scenario solves and only the
dispatched rows are accepted. Under a streamed scenario source such a
pass binds the source to the dispatched ids, so only the dispatched
chunks are staged (fewer bytes per partial iteration).

Options (reference names): APHnu, APHgamma, dispatch_frac, aph_use_lag.
Under active-set compaction (ops/shrink) an iteration whose miditer
crossed a bucket dispatches every scenario once: the solve width changed
and every warm store rebuilds, so the duals re-materialize at the new
width before partial dispatch resumes.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .. import global_toc, obs
from ..ops.dispatch import (GATE_HEAD, dispatch_gate, dispatch_select,
                            scalar_gate)
from ..utils.runtime import to_host
from .ph import PHBase


def aph_theta_step(u, ybar, W, z, xbar, tau, phi, nu, gamma, iter1: bool):
    """The θ-step given GLOBAL (τ, φ): θ = νφ/τ when a separating
    hyperplane was found (τ, φ > 0), W += θu, z += θȳ/γ (z := x̄ at
    iter 1) (ref. aph.py:451-486 Update_theta_zw). Shared by the
    in-process update below and the sharded engine (core/aph_shard.py),
    which feeds it reduced host scalars. Returns (W, z, θ)."""
    tau = torch.as_tensor(tau, dtype=W.dtype, device=W.device)
    phi = torch.as_tensor(phi, dtype=W.dtype, device=W.device)
    theta = torch.where((tau > 0) & (phi > 0),
                        nu * phi / torch.clamp(tau, min=1e-30),
                        torch.zeros_like(tau))
    W_new = W + theta * u
    z_new = xbar if iter1 else z + theta * ybar / gamma
    return W_new, z_new, theta


def aph_conv_metric(pusq, pvsq, pwsq, pzsq):
    """‖u‖_p/‖W‖_p + ‖v‖_p/‖z‖_p from the four reduced square norms
    (ref. aph.py:497-523 Compute_Convergence); inf until W and z carry
    mass. Shared by both engines."""
    pusq, pvsq, pwsq, pzsq = (torch.as_tensor(v, dtype=torch.float64)
                              if not isinstance(v, torch.Tensor) else v
                              for v in (pusq, pvsq, pwsq, pzsq))
    return torch.where(
        (pwsq > 0) & (pzsq > 0),
        torch.sqrt(pusq) / torch.sqrt(torch.clamp(pwsq, min=1e-30))
        + torch.sqrt(pvsq) / torch.sqrt(torch.clamp(pzsq, min=1e-30)),
        torch.full_like(pusq, torch.inf))


def _aph_update(xn, W, y, z, rho, prob, xbar, ybar, nu, gamma, iter1: bool,
                reduce_sum=None):
    """The projective-hedging update: the side-gig quantities, the
    θ-step, convergence and the post-step φ per scenario. xbar/ybar are
    the FirstReduce results. On a sharded mesh ``reduce_sum`` sums a
    stack of partial scalars over the ranks: the SecondReduce, once for
    (‖u‖²_p, ‖ȳ‖²_p, φ) before the θ-step and once for the norms of the
    stepped (W, z)."""
    red = reduce_sum if reduce_sum is not None else (lambda t: t)
    u = xn - xbar                                     # (S, K)
    pusq, pvsq, phi = red(torch.stack([
        torch.dot(prob, torch.sum(u * u, dim=1)),
        torch.dot(prob, torch.sum(ybar * ybar, dim=1)),
        torch.dot(prob, torch.sum((z - xn) * (W - y), dim=1))]))
    tau = pusq + pvsq / gamma
    W_new, z_new, theta = aph_theta_step(u, ybar, W, z, xbar, tau, phi,
                                         nu, gamma, iter1)
    pwsq, pzsq = red(torch.stack([
        torch.dot(prob, torch.sum(W_new * W_new, dim=1)),
        torch.dot(prob, torch.sum(z_new * z_new, dim=1))]))
    conv = aph_conv_metric(pusq, pvsq, pwsq, pzsq)
    # post-step per-scenario phis drive dispatch (ref. aph.py:755)
    phis = prob * torch.sum((z_new - xn) * (W_new - y), dim=1)
    return W_new, z_new, tau, phi, theta, conv, phis, pusq, pvsq, pwsq, pzsq


class APH(PHBase):
    """Asynchronous Projective Hedging engine (ref. mpisppy/opt/aph.py:54).

    The reference's ``y`` (dual estimate) is ``y_aph`` here: PHBase.yA/yB
    carry the QP duals of the last solve."""

    def __init__(self, batch, options=None, **kw):
        super().__init__(batch, options, **kw)
        o = self.options
        self.nu = float(o.get("APHnu", 1.0))
        self.gamma = float(o.get("APHgamma", 1.0))
        self.dispatch_frac = float(o.get("dispatch_frac", 1.0))
        self.use_lag = bool(o.get("aph_use_lag", False))
        S, K = self.batch.S, self.batch.K
        zeros = lambda: torch.zeros((S, K), dtype=self.dtype,  # noqa: E731
                                    device=self.device)
        self.z, self.y_aph, self.ybar = zeros(), zeros(), zeros()
        # phis lives on the device between iterations (the selection
        # reads it there); tests and APHShard may assign host arrays
        self.phis = np.zeros(S)
        # indexed by GLOBAL scenario: on a sharded mesh every rank ranks
        # the whole φ vector, so each holds every rank's dispatch ages
        self._last_dispatch = np.zeros(self.global_batch.S, np.int64)
        self._dispatched = np.ones(S, bool)   # iter 0 solves everyone
        self.theta = 0.0
        self.tau = self.phi = 0.0
        self._phi_stats = None   # the gate's φ-histogram row
        self._aph_status = None  # per-iteration dispatch record
        self._aph_shrink_bucket = None  # the bucket of the last solve

    # ---- dispatch selection (ref. aph.py:592-640 _dispatch_list) ----
    def _dispatch_mask(self, it, frac):
        """The dispatch mask as a host array, through the device
        selection (ops/dispatch.dispatch_select). The in-process loop
        reads the same selection from its packed gate; this spelling
        serves APHShard's per-shard pools and the tests. Zero-probability
        pad rows are excluded from both the budget and the pools."""
        S_real = self._S_orig
        scnt = max(1, int(np.ceil(S_real * frac)))
        if scnt >= S_real:
            mask = np.zeros(self.batch.S, bool)
            mask[:S_real] = True
            return mask
        phis = torch.as_tensor(self.phis, device=self.device)
        last = torch.as_tensor(self._last_dispatch, device=self.device)
        return to_host(dispatch_select(phis, last, scnt, S_real))

    def _dispatch_capable(self):
        """True when partial dispatch can SKIP solves: the chunked loop
        with a shared A, unsharded. Other engines, a sharded one
        included (its ranks' solve passes must stay in step), keep
        masked acceptance."""
        if self._shard_ops is not None:
            return False
        chunk = int(self.options.get("subproblem_chunk", 0) or 0)
        return 0 < chunk < self.batch.S \
            and getattr(self.qp_data.A, "ndim", 0) == 2

    # ---- the solve with prox against z (ref. aph.py:866-883) ----
    def _aph_solve(self, mask, didx=None):
        """Batched solve of min f_s + W·x + (ρ/2)‖x−z‖² for the
        dispatched scenarios. With ``didx`` (host ids, ascending) the
        chunked loop solves ONLY those scenarios and scatters their rows
        back. Without it every scenario solves and non-dispatched
        results are not accepted. The prox centre (x̄) and W are swapped
        to (z, W or their lags) for the solve, the chunks' cost assembly
        included, and restored afterwards."""
        W_solve = self._W_lag if self.use_lag else self.W
        z_solve = self._z_lag if self.use_lag else self.z
        saved_xbar, saved_W = self.xbar, self.W
        x_old = self.x
        yA_old, yB_old = getattr(self, "yA", None), getattr(self, "yB", None)
        self.xbar, self.W = z_solve, W_solve   # prox centre := z
        try:
            self.solve_loop(w_on=True, prox_on=True, update=False,
                            dispatch=didx)
        finally:
            self.xbar, self.W = saved_xbar, saved_W
        m = torch.as_tensor(mask, device=self.device)[:, None]
        if didx is None:
            # masked acceptance: all S solved, dispatched rows accepted
            obs.counter_add("dispatch.solved_scenarios", self._S_orig)
            self.x = torch.where(m, self.x, x_old)
            # dual merge only at matching widths: a bucket transition
            # changes the QP dual width (its pass dispatches everyone)
            if yA_old is not None and yA_old.shape == self.yA.shape \
                    and yB_old.shape == self.yB.shape:
                self.yA = torch.where(m, self.yA, yA_old)
                self.yB = torch.where(m, self.yB, yB_old)
        # else: the dispatch-masked chunked pass already scattered only
        # the dispatched rows into x/yA/yB (and booked the counters)
        if self.use_lag:
            # dispatched scenarios pick up the current (W, z) for their
            # NEXT solve (ref. aph.py:671-683 _update_foropt)
            self._W_lag = torch.where(m, self.W, self._W_lag)
            self._z_lag = torch.where(m, self.z, self._z_lag)
        self._last_dispatch[self._row0:self._row0 + mask.size][mask] = \
            self._iter
        self._dispatched = mask

    # ---- main loop (ref. aph.py:704-815 APH_iterk, :818 APH_main) ----
    def APH_main(self, spcomm=None, finalize=True):
        if spcomm is not None:
            self.spcomm = spcomm
        spcomm = self.spcomm
        self._ext("pre_iter0")
        # Iter 0: W and prox off, as PH.ph_main (a loaded W solves with
        # W on, a loaded x̄ survives iter 0)
        warm = getattr(self, "_warm_started", False)
        warm_xbar = getattr(self, "_warm_started_xbar", False)
        self.solve_loop(w_on=warm, prox_on=False, update=not warm_xbar)
        self.assert_feasible_iter0()
        if not warm:
            self.Update_W()   # W = rho(x - xbar)
        self.trivial_bound = self.Ebound()
        self.best_bound = self.trivial_bound
        self._iter = 0
        self._ext("post_iter0")
        if self.converger_cls is not None:
            self.converger = self.converger_cls(self)
        global_toc(f"APH iter 0: trivial bound = {self.trivial_bound:.4f}",
                   self.verbose)
        if self.use_lag:
            self._W_lag = self.W
            self._z_lag = self.z

        nu, gamma = self.nu, self.gamma
        S, S_real = self.batch.S, self._S_orig
        # a sharded mesh: the SecondReduce scalars are summed over the
        # ranks, and the dispatch ranks the GLOBAL φ (every rank's rows
        # in one zero-buffer all-reduce); each rank keeps its rows of
        # the mask, and the gate stays one read per iteration
        sh = self._shard_ops
        red = None if sh is None else self.mesh.all_sum
        lo = self._row0
        for it in range(1, self.max_iterations + 1):
            self._iter = it
            t_it = _time.perf_counter()
            xn = self.nonants_of(self.x)
            # Update_y on the previously dispatched set (ref. aph.py:
            # 157-186; y ≡ 0 at iter 1)
            if it > 1:
                W_y = self._W_lag if self.use_lag else self.W
                z_y = self._z_lag if self.use_lag else self.z
                y_new = W_y + self.rho * (xn - z_y)
                d = torch.as_tensor(self._dispatched,
                                    device=self.device)[:, None]
                self.y_aph = torch.where(d, y_new, self.y_aph)
            # FirstReduce + projective step
            xbar = self.compute_xbar(xn)
            xsqbar = self.compute_xbar(xn * xn)
            ybar = self.compute_xbar(self.y_aph)
            (self.W, self.z, tau, phi, theta, conv, phis,
             pusq, pvsq, pwsq, pzsq) = _aph_update(
                xn, self.W, self.y_aph, self.z, self.rho, self.prob,
                xbar, ybar, nu, gamma, iter1=(it == 1), reduce_sum=red)
            self.xbar, self.xsqbar, self.ybar = xbar, xsqbar, ybar
            self.phis = phis
            phis_all = phis if sh is None else self.gather_rows(phis)
            # dispatch (frac 1 at iter 1 "to get a decent w for
            # everyone", ref. aph.py:783-786); the selection rides the
            # same packed gate as the projective scalars
            frac = 1.0 if it == 1 else self.dispatch_frac
            scnt = max(1, int(np.ceil(S_real * frac)))
            full = scnt >= S_real
            if full:
                gate = scalar_gate(tau, phi, theta, conv, phis_all, S_real)
            else:
                gate = dispatch_gate(
                    tau, phi, theta, conv, phis_all,
                    torch.as_tensor(self._last_dispatch,
                                    device=self.device), scnt, S_real)
            # THE one device-to-host read of the iteration
            g = to_host(gate)
            obs.counter_add("aph.gate_syncs")
            (self.tau, self.phi, self.theta, self.conv,
             phi_min, phi_max, phi_neg) = g[:GATE_HEAD].tolist()
            self._phi_stats = {"phi_min": phi_min, "phi_max": phi_max,
                               "phi_neg": int(phi_neg)}
            if full:
                gmask = np.arange(self._last_dispatch.size) < S_real
            else:
                gmask = g[GATE_HEAD:] != 0
            mask = gmask[lo:lo + S]

            if self.verbose and (it % 10 == 0 or it == 1):
                global_toc(f"APH iter {it}: conv={self.conv:.6e} "
                           f"tau={self.tau:.3e} phi={self.phi:.3e} "
                           f"theta={self.theta:.3e}")
            if spcomm is not None:
                spcomm.sync()
                if spcomm.is_converged():
                    global_toc(f"APH iter {it}: hub termination",
                               self.verbose)
                    break
            if self.converger is not None and self.converger.is_converged():
                global_toc(f"APH iter {it}: converger termination",
                           self.verbose)
                break
            if self.conv is not None and self.conv < self.convthresh:
                global_toc(f"APH iter {it}: conv={self.conv:.3e} < thresh",
                           self.verbose)
                break
            self._ext("miditer")
            cur_bucket = self._shrink.bucket \
                if self._shrink is not None else None
            if not full and cur_bucket != self._aph_shrink_bucket:
                # a compaction bucket transition landed in this
                # miditer: dispatch everyone this ONE iteration (iter
                # 1's warm-up rule) so the duals re-materialize at the
                # new width; partial dispatch resumes next iteration
                full = True
                gmask = np.arange(self._last_dispatch.size) < S_real
                mask = gmask[lo:lo + S]
            self._aph_shrink_bucket = cur_bucket
            didx = None
            if not full and self._dispatch_capable():
                didx = np.flatnonzero(mask)
            self._aph_solve(mask, didx=didx)
            if sh is not None:
                # the other ranks' rows of the dispatch ages
                self._last_dispatch[gmask] = it
            self._aph_status = {
                "frac": frac, "scnt": scnt, "S_real": S_real,
                "dispatched": int(gmask.sum()),
                "solve_path": "chunked-skip" if didx is not None
                else ("full" if full else "masked-accept"),
                **(self._phi_stats or {})}
            if obs.enabled():
                t_end = _time.perf_counter()
                obs.complete_span("ph.iteration", t_it, t_end, cat="ph",
                                  args={"iter": it})
                obs.histogram_observe("ph.iteration_seconds", t_end - t_it)
                rec = {"iter": it, "conv": self.conv,
                       "seconds": t_end - t_it, "aph": self._aph_status}
                if self._stream_source is not None:
                    rec["stream"] = self._stream_source.status()
                obs.event("ph.iteration", rec)
            self._ext("enditer")

        if finalize:
            return self.post_loops()
        return self.conv, None, self.trivial_bound

    def post_loops(self):
        self._ext("post_everything")
        return self.conv, self.Eobjective_value(), self.trivial_bound

    def _hub_nonants(self):
        return self.nonants_of(self.x)

    # ---- checkpoint state ----
    # An APH resume needs more than PH's (W, x̄, x̄², ρ): (z, y) drive
    # the next θ-step, x the next y-update, and (phis, last-dispatch,
    # dispatched) reproduce the next dispatch selection exactly.

    def aph_state_arrays(self):
        """Host copies of the APH-specific state, real rows only. Keys
        carry the ``aph_`` prefix (checkpoint bundle extras)."""
        S_real = self._S_orig
        return {
            "aph_z": to_host(self.z)[:S_real],
            "aph_y": to_host(self.y_aph)[:S_real],
            "aph_x": to_host(self.x)[:S_real],
            "aph_phis": to_host(self.phis, np.float64)[:S_real],
            "aph_last_dispatch":
                np.asarray(self._last_dispatch)[:S_real].astype(np.int64),
            "aph_dispatched":
                np.asarray(self._dispatched)[:S_real].astype(np.int64),
        }

    def install_aph_state(self, arrays):
        """Inverse of :meth:`aph_state_arrays`: pad the real rows back
        to S by repeating the last row and restore each field's home
        (device tensors, host bookkeeping)."""
        S = self.batch.S

        def _pad(a):
            a = np.asarray(a)
            if a.shape[0] < S:
                reps = np.repeat(a[-1:], S - a.shape[0], axis=0)
                a = np.concatenate([a, reps], axis=0)
            return a

        def dev(a):
            return torch.as_tensor(_pad(a), dtype=self.dtype,
                                   device=self.device)

        self.z = dev(arrays["aph_z"])
        self.y_aph = dev(arrays["aph_y"])
        self.x = dev(arrays["aph_x"])
        self.phis = dev(arrays["aph_phis"])
        self._last_dispatch = _pad(
            arrays["aph_last_dispatch"]).astype(np.int64)
        self._dispatched = _pad(arrays["aph_dispatched"]).astype(bool)
