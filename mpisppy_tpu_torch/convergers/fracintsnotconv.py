"""FractionalConverger: fraction of integer nonants not yet agreed.

ref. mpisppy/convergers/fracintsnotconv.py:12 — converged when the fraction
of integer nonant variables whose scenario values still differ (x̄² vs
x̄²-bar variance test) drops below ``fracintsnotconv_conv_thresh``.
"""

from __future__ import annotations

import numpy as np

from ..utils.runtime import to_host
from .converger import Converger


class FractionalConverger(Converger):
    def __init__(self, opt):
        super().__init__(opt)
        o = opt.options
        self.thresh = float(o.get("fracintsnotconv_conv_thresh", 0.05))
        self.tol = float(o.get("fracintsnotconv_tol", 1e-4))
        self.imask = opt.nonant_integer_mask
        self.nints = max(int(self.imask.sum()), 1)
        self.last_frac = 1.0

    def is_converged(self) -> bool:
        xbar = to_host(self.opt.xbar)
        xsqbar = to_host(self.opt.xsqbar)
        var = np.max(np.abs(xsqbar - xbar * xbar), axis=0)   # (K,)
        notconv = (var > self.tol * self.tol) & self.imask
        self.last_frac = float(notconv.sum()) / self.nints
        return self.last_frac < self.thresh
