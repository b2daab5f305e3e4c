"""Diagnoser: per-scenario per-iteration objective dump (the port of the
JAX package's extensions/diagnoser.py).

ref. mpisppy/extensions/diagnoser.py:16-71 (writes one file per rank into
``diagnoser_options["diagnoser_outdir"]``). Here one process holds every
scenario, so a single CSV accumulates (iter, scenario, objective) rows.
"""

from __future__ import annotations

import os

from ..utils.runtime import to_host
from .extension import Extension


class Diagnoser(Extension):
    def __init__(self, options=None):
        super().__init__(options)
        o = self.options.get("diagnoser_options", self.options)
        self.outdir = o.get("diagnoser_outdir", ".")
        self.rows = []

    def _record(self, opt):
        obj = to_host(opt._last_base_obj)
        it = opt._iter
        for s, v in enumerate(obj):
            self.rows.append((it, opt.batch.tree.scen_names[s], float(v)))

    def post_iter0(self, opt):
        self._record(opt)

    def enditer(self, opt):
        self._record(opt)

    def post_everything(self, opt):
        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, "diagnoser.csv")
        with open(path, "w") as f:
            f.write("iter,scenario,objective\n")
            for it, name, v in self.rows:
                f.write(f"{it},{name},{v}\n")
