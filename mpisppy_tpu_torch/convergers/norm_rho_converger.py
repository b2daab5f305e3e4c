"""NormRhoConverger: primal+dual residual norm criterion.

ref. mpisppy/convergers/norm_rho_converger.py:12 — pairs with
NormRhoUpdater: converged when the prob-weighted primal residual
‖x − x̄‖₁ plus the dual residual ρ‖x̄ − x̄_prev‖₁ falls below
``norm_rho_converger_conv_thresh``.
"""

from __future__ import annotations

import numpy as np

from ..utils.runtime import to_host
from .converger import Converger


class NormRhoConverger(Converger):
    def __init__(self, opt):
        super().__init__(opt)
        self.thresh = float(opt.options.get("norm_rho_converger_conv_thresh", 1e-4))
        self._prev_xbar = None
        self.last_norm = np.inf

    def is_converged(self) -> bool:
        opt = self.opt
        xn = to_host(opt._hub_nonants())
        xbar = to_host(opt.xbar)
        prob = to_host(opt.prob)
        prim = float(prob @ np.abs(xn - xbar).sum(axis=1))
        dual = 0.0
        if self._prev_xbar is not None:
            dual = float(np.mean(to_host(opt.rho)) *
                         np.abs(xbar - self._prev_xbar).sum() / max(opt.batch.S, 1))
        self._prev_xbar = xbar
        self.last_norm = prim + dual
        return self.last_norm < self.thresh
