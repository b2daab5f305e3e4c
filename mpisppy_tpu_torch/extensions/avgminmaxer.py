"""MinMaxAvg: print avg/min/max of a named variable across scenarios
(the port of the JAX package's extensions/avgminmaxer.py).

ref. mpisppy/extensions/avgminmaxer.py:10 (options key ``avgminmax_name``).
"""

from __future__ import annotations

from .extension import Extension


class MinMaxAvg(Extension):
    def __init__(self, options=None):
        super().__init__(options)
        self.compstr = self.options.get("avgminmax_name", None)
        self.history = []

    def _show(self, opt, when):
        if self.compstr is None or opt.x is None:
            return
        vals = opt.gather_var_values(opt.x)
        if self.compstr not in vals:
            raise KeyError(f"avgminmax_name {self.compstr!r} is not a "
                           f"variable: {list(vals)}")
        arr = vals[self.compstr]
        per_scen = arr.sum(axis=1)   # scalar summary per scenario
        avg, mn, mx = (float(per_scen.mean()), float(per_scen.min()),
                       float(per_scen.max()))
        self.history.append((when, avg, mn, mx))
        print(f"====> {when} {self.compstr}: avg={avg:.4f} min={mn:.4f} "
              f"max={mx:.4f}")

    def post_iter0(self, opt):
        self._show(opt, f"iter {opt._iter}")

    def enditer(self, opt):
        self._show(opt, f"iter {opt._iter}")

    def post_everything(self, opt):
        self._show(opt, "final")
