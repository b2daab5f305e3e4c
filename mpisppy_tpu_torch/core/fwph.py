"""FWPH: Frank–Wolfe Progressive Hedging (Boland et al. 2018; the port
of the JAX package's core/fwph.py).

The reference (ref. mpisppy/fwph/fwph.py:52-1043) pairs each scenario
MIP with a companion QP over the convex hull of discovered MIP
solutions, runs a Simplicial Decomposition Method inner loop (solve QP
→ set W → solve MIP → add column → Γ check, ref. fwph.py:210-303 SDM),
swaps the nonant pointers so PH's x̄/W updates read the *QP* solutions
(ref. fwph.py:989-1018 _swap_nonant_vars), and publishes a Lagrangian
dual bound from the inner linearized solves (ref. fwph.py:526
_compute_dual_bound). Two-stage only, like the reference (ref.
fwph.py:439-442).

Batched form:
- the column pool is a fixed-shape rolling buffer (S, C, n): slots start
  as copies of the iter-0 solution and are overwritten round-robin;
- the weight QP batches over scenarios (ops/simplex_qp: accelerated
  projected gradient over the simplex);
- the linearized ("MIP") subproblem is one batched solve in PH's
  prox-off, W-on mode, on the prox-off factor and its warm state (the
  engine's ``_qp_states[False]``), through the engine's solve path (the
  ADMM block with the fused ``cuda`` backend);
- the dual bound is taken at the *first* SDM pass of each outer
  iteration, where E[w] = 0 holds exactly (W from the PH update plus
  ρ(x_t − x̄) with x̄ = E[x_t]), so the published bound is a certified
  Lagrangian bound built from the solver's dual vectors.
"""

from __future__ import annotations

import torch

from .. import global_toc
from ..ops.simplex_qp import simplex_qp_solve
from .ph import PHBase


class FWPH(PHBase):
    def __init__(self, batch, options=None, rho_setter=None, extensions=None,
                 converger=None, dtype=None, device=None, mesh=None):
        super().__init__(batch, options, rho_setter, extensions, converger,
                         dtype, device=device, mesh=mesh)
        if batch.tree.num_stages != 2:
            raise ValueError("FWPH is two-stage only (ref. fwph.py:439-442)")
        opts = self.options
        self.FW_iter_limit = int(opts.get("FW_iter_limit", 3))
        self.FW_conv_thresh = float(opts.get("FW_conv_thresh", 1e-4))
        self.max_columns = int(opts.get("fwph_max_columns", 16))
        self.qp_iters = int(opts.get("fwph_qp_iters", 400))
        self._local_bound = None
        self._col_ptr = 0

    # ---- column pool ----
    def _init_columns(self, x0):
        S, n = self.batch.S, self.batch.n
        self.columns = x0.unsqueeze(1).expand(S, self.max_columns,
                                              n).clone()
        self._col_ptr = 0

    def add_column(self, x):
        """Round-robin overwrite (the rolling pad for Pyomo's growing
        column set, ref. fwph.py:305-352 _add_QP_column). The pool is
        the engine's own tensor, so the slot is written in place."""
        self.columns[:, self._col_ptr % self.max_columns, :] = x
        self._col_ptr += 1

    # ---- the SDM inner loop (ref. fwph.py:210-303) ----
    def SDM(self, first_pass_bound=True):
        """One simplicial-decomposition pass. Ordering matters for bound
        validity: w is set from the *incumbent* QP iterate x_t, whose
        scenario mean IS x̄ at the first pass (x̄ was computed from it at
        the end of the previous outer iteration), so E[w] = 0 there and
        the first linearized solve yields a certified Lagrangian bound
        (the reference computes its dual bound at the same point,
        ref. fwph.py:526 _compute_dual_bound).

        The linearized solve reads ``self.W``: it is set to w_t for that
        solve and restored afterwards. Nothing writes W in place (every
        update builds a new tensor), so the saved W is the one restored."""
        b = self.batch
        idx = self.nonant_idx
        base = (self.columns @ self.c.unsqueeze(-1)).squeeze(-1)  # (S, C)
        a = getattr(self, "_a", None)
        if a is None or tuple(a.shape) != (b.S, self.max_columns):
            a = torch.full((b.S, self.max_columns), 1.0 / self.max_columns,
                           dtype=self.dtype, device=self.device)
        xn_t = self._xn_t
        gamma = float("inf")
        for k in range(self.FW_iter_limit):
            w_t = self.W + self.rho * (xn_t - self.xbar)
            # linearized subproblem: min (c + scatter(w_t))'x over the
            # original feasible set, on PH's prox-off factor
            saved_W = self.W
            self.W = w_t
            try:
                self.solve_loop(w_on=True, prox_on=False, update=False)
            finally:
                self.W = saved_W
            x_star = self.x
            if k == 0 and first_pass_bound:
                prev = (self._local_bound if self._local_bound is not None
                        else -float("inf"))
                self._local_bound = max(prev, self.Ebound())
            # Γ: linearization gap of the QP iterate vs the new vertex
            lin_t = (torch.sum(base * a, dim=-1) + self.c0
                     + torch.sum(w_t * xn_t, dim=-1))
            lin_star = (torch.sum(self.c * x_star, dim=-1) + self.c0
                        + torch.sum(w_t * x_star[:, idx], dim=-1))
            gamma = float(self.Eobjective(lin_t - lin_star))
            self.add_column(x_star)
            G = self.columns[:, :, idx]
            base = (self.columns @ self.c.unsqueeze(-1)).squeeze(-1)
            a, xn_t = simplex_qp_solve(G, base, self.W, self.rho, self.xbar,
                                       a, iters=self.qp_iters)
            if abs(gamma) < self.FW_conv_thresh * max(1.0, abs(float(
                    self.Eobjective(lin_t)))):
                break
        self._a = a
        self._xn_t = xn_t
        return xn_t, gamma

    # ---- the outer loop (ref. fwph.py:142-208 fwph_main) ----
    def fwph_main(self, finalize=True):
        # iter 0: plain solves seed the pool and x̄ (ref. fwph.py:156-168).
        # Warm-start semantics match PH.ph_main: a loaded W solves with W
        # on, a loaded xbar survives iter 0 unoverwritten.
        warm = getattr(self, "_warm_started", False)
        warm_xbar = getattr(self, "_warm_started_xbar", False)
        self.solve_loop(w_on=warm, prox_on=False, update=not warm_xbar)
        self._init_columns(self.x)
        self._xn_t = self.nonants_of(self.x)   # E[xn_t] = x̄ holds at start
        if not warm:
            self.Update_W()   # W=0 before, so W = rho(x - xbar)
        self.trivial_bound = self.Ebound()
        self._local_bound = self.trivial_bound
        self._iter = 0

        for it in range(1, self.max_iterations + 1):
            self._iter = it
            xn_t, gamma = self.SDM()
            # PH updates read the QP solutions (the reference's
            # _swap_nonant_vars pointer trick, ref. fwph.py:989)
            self.xbar = self.compute_xbar(xn_t)
            self.xsqbar = self.compute_xbar(xn_t * xn_t)
            self.W = self.W + self.rho * (xn_t - self.xbar)
            self.conv = float(self.Eobjective(
                torch.sum(torch.abs(xn_t - self.xbar), dim=1))) \
                / self.batch.K
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    break
            if self.conv < self.convthresh:
                global_toc(f"FWPH iter {it}: conv={self.conv:.3e} < thresh",
                           self.verbose)
                break
            if self.verbose and it % 10 == 0:
                global_toc(f"FWPH iter {it}: conv={self.conv:.4e} "
                           f"bound={self._local_bound:.4f} Γ={gamma:.3e}")
        if finalize:
            return self.conv, self._local_bound, self.trivial_bound
        return self.conv

    def _hub_nonants(self):
        xn_t = getattr(self, "_xn_t", None)
        if xn_t is None:
            return super()._hub_nonants()
        return xn_t   # simplex_qp_solve already returns a @ columns[nonants]
