"""NormRhoUpdater: adaptive rho from primal/dual residual balance (the
port of the JAX package's extensions/norm_rho_updater.py; its
per-slot ``DeviceNormRhoUpdater`` belongs to the shrinking slice,
ROADMAP.md A9).

ref. mpisppy/extensions/norm_rho_updater.py:33. Classic residual
balancing (Boyd et al. §3.4.1 as the reference cites): per iteration
compute the primal residual ‖x − x̄‖ (prob-weighted, reduced over
scenarios) and the dual residual ρ‖x̄ − x̄_prev‖; multiply rho by
``rho_update_factor`` when primal > mult·dual, divide when
dual > mult·primal. One scalar factor moves the whole rho block, and
every applied update drops the engine's prox-on factors (rho sits on
the prox diagonal).

Residual histories are bounded deques (``history_cap``, default 512).
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


def __getattr__(name):
    if name == "DeviceNormRhoUpdater":
        raise NotImplementedError(
            "DeviceNormRhoUpdater (the per-slot device-side rho update "
            "over ops/shrink) is not ported yet (see ROADMAP.md A9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
