"""NormRhoUpdater and DeviceNormRhoUpdater: adaptive rho from
primal/dual residual balance (the port of the JAX package's
extensions/norm_rho_updater.py).

ref. mpisppy/extensions/norm_rho_updater.py:33. Classic residual
balancing (Boyd et al. §3.4.1 as the reference cites): per iteration
compute the primal residual ‖x − x̄‖ (prob-weighted, reduced over
scenarios) and the dual residual ρ‖x̄ − x̄_prev‖; multiply rho by
``rho_update_factor`` when primal > mult·dual, divide when
dual > mult·primal. One scalar factor moves the whole rho block, and
every applied update drops the engine's prox-on factors (rho sits on
the prox diagonal).

``DeviceNormRhoUpdater`` balances per nonant SLOT on the device
(ops/shrink.per_slot_rho_update). Residual histories are bounded deques
(``history_cap``, default 512).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..utils.runtime import to_host
from .extension import Extension

HISTORY_CAP_DEFAULT = 512


class NormRhoUpdater(Extension):
    def __init__(self, options=None):
        super().__init__(options)
        o = self.options.get("norm_rho_options", self.options)
        self.mult = float(o.get("primal_dual_mult", 10.0))
        self.factor = float(o.get("rho_update_factor", 2.0))
        self.verbose = bool(o.get("verbose", False))
        cap = int(o.get("history_cap", HISTORY_CAP_DEFAULT))
        self._prev_xbar = None
        self.prim_hist = deque(maxlen=cap)
        self.dual_hist = deque(maxlen=cap)

    def reset(self):
        """Forget per-run state."""
        self._prev_xbar = None
        self.prim_hist.clear()
        self.dual_hist.clear()

    def miditer(self, opt):
        xn = opt._hub_nonants()
        xbar = opt.xbar
        prim = float(torch.dot(opt.prob,
                               torch.sum(torch.abs(xn - xbar), dim=1)))
        xbar_h = to_host(xbar)
        if self._prev_xbar is None:
            self._prev_xbar = xbar_h
            return
        dual = float(np.mean(to_host(opt.rho)) *
                     np.abs(xbar_h - self._prev_xbar).sum() /
                     max(opt.batch.S, 1))
        self._prev_xbar = xbar_h
        self.prim_hist.append(prim)
        self.dual_hist.append(dual)
        if prim > self.mult * dual:
            opt.rho = opt.rho * self.factor
            opt.invalidate_factors()
            if self.verbose:
                print(f"NormRhoUpdater it {opt._iter}: rho *= "
                      f"{self.factor} (prim {prim:.3e} dual {dual:.3e})")
        elif dual > self.mult * prim:
            opt.rho = opt.rho / self.factor
            opt.invalidate_factors()
            if self.verbose:
                print(f"NormRhoUpdater it {opt._iter}: rho /= "
                      f"{self.factor} (prim {prim:.3e} dual {dual:.3e})")


class DeviceNormRhoUpdater(Extension):
    """Per-slot residual balancing as device ops. The host pays one
    (3,) read per update pass ([changed, prim_sum, dual_sum]; the
    history samples ride it). ``shrink_rho_interval`` spaces the update
    passes: every APPLIED update drops the prox-on factors, and on the
    block path each drop costs a new explicit (n, n) inverse, booked by
    the engine as a re-factorization.

    options: ``primal_dual_mult``, ``rho_update_factor``,
    ``shrink_rho_interval`` (or ``update_interval``), ``history_cap``."""

    def __init__(self, options=None):
        super().__init__(options)
        o = self.options.get("norm_rho_options", self.options)
        self.mult = float(o.get("primal_dual_mult", 10.0))
        self.factor = float(o.get("rho_update_factor", 2.0))
        self.interval = int(o.get("shrink_rho_interval",
                                  o.get("update_interval", 1)))
        self.verbose = bool(o.get("verbose", False))
        cap = int(o.get("history_cap", HISTORY_CAP_DEFAULT))
        self._prev_xbar = None
        self.prim_hist = deque(maxlen=cap)
        self.dual_hist = deque(maxlen=cap)
        self.updates = 0

    def reset(self):
        """Forget per-run state."""
        self._prev_xbar = None
        self.prim_hist.clear()
        self.dual_hist.clear()
        self.updates = 0

    def miditer(self, opt):
        # the previous x̄ refreshes EVERY miditer (a device reference),
        # not only on update passes: the dual residual must span one
        # iteration like the primal one
        prev, self._prev_xbar = self._prev_xbar, opt.xbar
        if prev is None:
            return
        if self.interval > 1 and opt._iter % self.interval:
            return
        from .. import obs
        from ..ops.shrink import per_slot_rho_update
        new_rho, stats = per_slot_rho_update(
            opt.rho, opt.prob, opt._hub_nonants(), opt.xbar, prev,
            self.mult, self.factor, mesh=getattr(opt, "shard_mesh", None))
        st = to_host(stats)       # the ONE (3,) read of the pass
        self.prim_hist.append(float(st[1]))
        self.dual_hist.append(float(st[2]))
        if st[0] > 0:
            opt.rho = new_rho
            opt.invalidate_factors()
            self.updates += 1
            obs.counter_add("shrink.rho_updates")
            obs.event("shrink.rho", {"iter": opt._iter,
                                     "prim_sum": float(st[1]),
                                     "dual_sum": float(st[2])})
            if self.verbose:
                print(f"DeviceNormRhoUpdater it {opt._iter}: per-slot "
                      f"rho update (prim {st[1]:.3e} dual {st[2]:.3e})")
