"""XhatClosest: try the scenario nearest to x̄ as the incumbent (the port
of the JAX package's extensions/xhatclosest.py).

ref. mpisppy/extensions/xhatclosest.py:10. The reference picks the
scenario minimizing a truncated z-score distance to x̄ (Allreduce MIN +
rank tie-break) and evaluates it via the xhat machinery. Here the
distance is one vectorized reduction over the (S, K) nonant block on
the host, and the evaluation is ``PHBase.calculate_incumbent`` (the
batched fixed-nonant solve on the engine's device).
"""

from __future__ import annotations

import numpy as np

from ..utils.runtime import to_host
from .extension import Extension


class XhatClosest(Extension):
    def __init__(self, options=None):
        super().__init__(options)
        o = self.options.get("xhat_closest_options", self.options)
        self.keep_solution = bool(o.get("keep_solution", True))
        self.best_bound = None     # inner (upper, for min) bound
        self.best_xhat = None

    def _distance(self, opt):
        xn = to_host(opt._hub_nonants())    # (S, K)
        xbar = to_host(opt.xbar)
        std = np.sqrt(np.maximum(to_host(opt.xsqbar) - xbar * xbar, 0.0))
        z = np.abs(xn - xbar) / np.maximum(std, 1e-6)
        z = np.minimum(z, 10.0)   # truncation, matching the reference's cap
        return z.sum(axis=1)      # (S,)

    def try_closest(self, opt):
        s = int(np.argmin(self._distance(opt)))
        xhat = to_host(opt._hub_nonants())[s]
        val = opt.calculate_incumbent(xhat)
        if val is not None and (self.best_bound is None
                                or val < self.best_bound):
            self.best_bound = val
            self.best_xhat = opt.round_nonants(xhat)
            if opt.spcomm is not None and hasattr(opt.spcomm,
                                                  "InnerBoundUpdate"):
                opt.spcomm.InnerBoundUpdate(val, char="C")
        return val

    def miditer(self, opt):
        self.try_closest(opt)

    def post_everything(self, opt):
        self.try_closest(opt)
        if opt.options.get("verbose"):
            print(f"XhatClosest: final inner bound {self.best_bound}")
