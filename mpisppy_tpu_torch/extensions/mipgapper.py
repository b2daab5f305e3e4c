"""Gapper: subproblem-tolerance schedule keyed by PH iteration (the port
of the JAX package's extensions/mipgapper.py).

ref. mpisppy/extensions/mipgapper.py:11. The reference sets the MIP
solver's ``mipgap`` option per a {iteration: gap} dict. In the batched
engine the analogous knob is the ADMM solver's stopping tolerance
(``subproblem_eps``): loose early iterations converge PH faster per
second, tight late iterations certify bounds, the trade the
reference's gap schedule expresses.
"""

from __future__ import annotations

from .extension import Extension


class Gapper(Extension):
    """options: {"mipgapdict": {iter: tol}}. At each scheduled iteration
    the engine's subproblem tolerance is replaced; every later solve
    reads it."""

    def __init__(self, options=None):
        super().__init__(options)
        self.schedule = {int(k): float(v) for k, v in
                         (self.options.get("mipgapdict") or {}).items()}

    def _apply(self, opt, it):
        if it in self.schedule:
            opt.sub_eps = self.schedule[it]
            if opt.options.get("verbose"):
                print(f"Gapper: subproblem_eps = {opt.sub_eps:g} at iter "
                      f"{it}")

    def pre_iter0(self, opt):
        self._apply(opt, 0)

    def miditer(self, opt):
        self._apply(opt, opt._iter)
