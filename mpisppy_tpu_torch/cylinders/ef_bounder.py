"""Host EF-MIP bound spoke (the port of mpisppy_tpu/cylinders/ef_bounder.py).

Solves the full equality-row extensive form as ONE host MILP (HiGHS B&B
in a kill-abortable oracle subprocess) and publishes BOTH of the solve's
bounds through a 2-value window [dual_bound, incumbent]:

- the B&B **dual bound** — a valid outer bound at any time_limit /
  mip_rel_gap stop, and the tightest outer bound any cylinder can
  produce when the EF fits a host B&B (a Lagrangian bound is capped at
  the Lagrangian dual, which sits a duality gap below the MIP optimum;
  measured on the 10-scenario UC bench instance: Lagrangian ceiling
  0.056% vs EF dual bound 0.001%);
- the **incumbent** objective (a feasible EF point — an inner bound),
  with the integer-feasible first-stage plan kept for ``finalize``.

One solve serves both sides — this is the one spoke typed both
OUTER_BOUND and INNER_BOUND (the hub reads [outer, inner] from its
window; NaN marks a side the solve could not produce).

The direct analog of the reference handing the monolithic EF to a
rented solver (ref. mpisppy/opt/ef.py:61 driving phbase.py:1307
SolverFactory) — run as a *cylinder* so the wheel gets exact-bound
quality at instance scales where the EF fits a host B&B, while the
Lagrangian + dive/oracle-xhat spokes carry the scales where it doesn't
(the EF of a 1000-scenario batch is beyond any single B&B run's time
budget; the batched device machinery and per-scenario oracles are not).
"""

from __future__ import annotations

import numpy as np

from .spoke import ConvergerSpokeType, Spoke


class EFMipBound(Spoke):
    """Options: ``efmip_time_limit`` (s, default 180), ``efmip_gap``
    (HiGHS mip_rel_gap, default 1e-4), ``efmip_workers`` (oracle pool
    size; the EF is one problem, so >1 never helps — default 1
    subprocess). Keep the subprocess default in wheels: inline mode
    (0) cannot abort the single B&B solve on the kill signal, so a
    fast-terminating wheel would wait out the full time limit and drop
    this spoke's bounds at the join deadline."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.INNER_BOUND)
    converger_spoke_char = "E"

    @staticmethod
    def payload_length(S, K) -> int:
        return 2            # [dual (outer), incumbent (inner)]

    def __init__(self, spbase_object, options=None, trace_prefix=None):
        super().__init__(spbase_object, options, trace_prefix)
        self.best_xhat = None
        self._pool = None
        self._init_trace("time,outer,inner")

    def _solve_ef(self):
        """Returns (dual_bound, incumbent_obj, x_ef) with None entries
        for whatever the solve could not produce."""
        from ..utils.host_oracle import ef_mip_pool

        try:
            self._pool = ef_mip_pool(
                self.opt.batch,
                n_workers=self.options.get("efmip_workers", 1))
            res = self._pool.scenario_values(
                milp=True,
                time_limit=float(self.options.get("efmip_time_limit",
                                                  180.0)),
                mip_gap=float(self.options.get("efmip_gap", 1e-4)),
                kill_check=self.killed, return_x=True)
        except Exception as e:
            # never crash the wheel over a host solver hiccup — but say
            # so: this may be the wheel's only bound source of its kind
            from .. import global_toc
            global_toc(f"{type(self).__name__}: EF solve failed "
                       f"({e!r}); publishing no bounds")
            return None, None, None
        if res is None:               # killed mid-solve
            return None, None, None
        vals, ok, _, xs = res
        dual = float(vals[0]) if ok[0] else None
        if xs[0] is not None:
            inc, x_ef = xs[0]
            return dual, float(inc), x_ef
        return dual, None, None

    def main(self):
        dual, inc, x_ef = self._solve_ef()
        if inc is not None and x_ef is not None:
            b = self.opt.batch
            n = b.n
            idx = np.asarray(b.nonant_idx)
            xhat = np.stack([x_ef[s * n:(s + 1) * n][idx]
                             for s in range(b.S)])
            self.best_xhat = self.opt.round_nonants(xhat)
            self.bound = inc
        if dual is not None or inc is not None:
            self.spoke_to_hub(np.array(
                [np.nan if dual is None else dual,
                 np.nan if inc is None else inc]))
            if self._trace_path:
                import time
                d = float("nan") if dual is None else dual
                i = float("nan") if inc is None else inc
                with open(self._trace_path, "a") as f:
                    f.write(f"{time.monotonic()},{d},{i}\n")
        # solved (or failed): idle on the kill signal like a looper
        # whose candidate stream is exhausted
        while not self.got_kill_signal():
            pass

    def finalize(self):
        if self._pool is not None:
            self._pool.close()
        return self.bound, self.best_xhat
