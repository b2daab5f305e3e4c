"""Fixer: WW-style iterative fixing of converged integer nonants (the
port of the JAX package's extensions/fixer.py; its ``DeviceFixer``
belongs to the shrinking slice, ROADMAP.md A9).

ref. mpisppy/extensions/fixer.py:50. The reference keeps a per-variable
conv counter driven by the x̄² ≈ x̄² ("xbar squared vs xsqbar") variance
test and fixes a variable after it has been converged for N consecutive
iterations — at its current common value (``nb``), or at its lower/upper
bound when parked there (``lb``/``ub``). Tuples ``(varid, th, nb, lb, ub)``
come from a user ``id_fix_list_fct``.

Batched form: the counters are (K,) integer arrays and the whole
test-and-fix is one vectorized host pass per ``miditer`` over the
engine's x̄, x̄² and nonants (read back from the device); fixing feeds
``PHBase.fix_nonants`` (bound pinning in the solve) with an accumulated
mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.runtime import to_host
from .extension import Extension


@dataclass
class FixerTuple:
    """Per-slot fixing thresholds (ref. fixer.py:20 Fixer_tuple). ``None``
    disables that mode. Counts are in consecutive converged iterations."""
    tol: float = 1e-4
    nb: int | None = None   # fix at value when converged this many iters
    lb: int | None = None   # fix at lower bound when parked there
    ub: int | None = None   # fix at upper bound when parked there


def uniform_fix_list(batch, tol=1e-4, nb=3, lb=3, ub=3, integer_only=True):
    """Convenience id_fix_list_fct: the same FixerTuple for every nonant
    slot (integer slots only by default, matching typical reference
    usage)."""
    K = batch.K
    integer_mask = np.asarray(batch.integer)[np.asarray(batch.nonant_idx)]
    active = integer_mask if integer_only else np.ones(K, bool)
    inf = np.iinfo(np.int64).max

    def to_arr(v):
        a = np.full(K, inf if v is None else int(v), dtype=np.int64)
        a[~active] = inf
        return a

    return {"tol": np.full(K, float(tol)),
            "nb": to_arr(nb), "lb": to_arr(lb), "ub": to_arr(ub)}


class Fixer(Extension):
    """options: {"id_fix_list_fct": batch -> dict(tol,nb,lb,ub arrays),
    "boundtol": float}. Counters update each ``miditer``; a slot fixed
    once stays fixed (the reference never unfixes, fixer.py docstring)."""

    def __init__(self, options=None):
        super().__init__(options)
        self._init_done = False

    def reset(self):
        """Forget per-run state."""
        self._init_done = False
        self.nfixed = 0

    def _setup(self, opt):
        K = opt.batch.K
        fct = self.options.get("id_fix_list_fct", None)
        spec = fct(opt.batch) if fct is not None \
            else uniform_fix_list(opt.batch)
        self.tol = np.asarray(spec["tol"], float)
        self.nb = np.asarray(spec["nb"], np.int64)
        self.lbc = np.asarray(spec["lb"], np.int64)
        self.ubc = np.asarray(spec["ub"], np.int64)
        self.boundtol = float(self.options.get("boundtol", 1e-6))
        self.conv_count = np.zeros(K, np.int64)   # value-converged streak
        self.lb_count = np.zeros(K, np.int64)     # parked-at-lb streak
        self.ub_count = np.zeros(K, np.int64)
        idx = np.asarray(opt.batch.nonant_idx)
        self.slot_lb = np.asarray(opt.batch.lb)[:, idx]   # (S,K)
        self.slot_ub = np.asarray(opt.batch.ub)[:, idx]
        self.fixed_mask = np.zeros((opt.batch.S, K), bool)
        self.fixed_vals = np.zeros((opt.batch.S, K))
        self._init_done = True
        self.nfixed = 0

    def post_iter0(self, opt):
        if not self._init_done:
            self._setup(opt)

    def miditer(self, opt):
        if not self._init_done:
            self._setup(opt)
        xbar = to_host(opt.xbar)             # (S,K)
        xsqbar = to_host(opt.xsqbar)
        xn = to_host(opt._hub_nonants())     # (S,K) current solutions
        # variance test per slot: all scenarios agree when
        # E[x^2]-E[x]^2 ~ 0 (ref. fixer.py xbar/xsqbar test). Reduce over
        # the scenario axis so the counter is per-slot even with
        # per-node xbars.
        var = np.max(np.abs(xsqbar - xbar * xbar), axis=0)
        agree = var <= self.tol * self.tol + 1e-15
        self.conv_count = np.where(agree, self.conv_count + 1, 0)
        at_lb = np.all(np.abs(xn - self.slot_lb) <= self.boundtol, axis=0)
        at_ub = np.all(np.abs(xn - self.slot_ub) <= self.boundtol, axis=0)
        self.lb_count = np.where(agree & at_lb, self.lb_count + 1, 0)
        self.ub_count = np.where(agree & at_ub, self.ub_count + 1, 0)

        fix_lb = self.lb_count >= self.lbc
        fix_ub = (self.ub_count >= self.ubc) & ~fix_lb
        fix_nb = (self.conv_count >= self.nb) & ~fix_lb & ~fix_ub
        newly = (fix_lb | fix_ub | fix_nb) & ~self.fixed_mask[0]
        if not newly.any():
            return
        # per-scenario values: on multistage trees each scenario's xbar
        # row carries its OWN node's mean (and bounds may differ per
        # scenario), so fixing uses the full (S, K) arrays; broadcasting
        # row 0 would pin non-root nonants at another node's value
        value = np.where(fix_lb[None, :], self.slot_lb,
                         np.where(fix_ub[None, :], self.slot_ub, xbar))
        # integer slots snap to the nearest integer before fixing
        imask = opt.nonant_integer_mask
        value = np.where(imask[None, :], np.round(value), value)
        self.fixed_vals[:, newly] = value[:, newly]
        self.fixed_mask[:, newly] = True
        self.nfixed = int(self.fixed_mask[0].sum())
        opt.fix_nonants(self.fixed_vals, mask=self.fixed_mask)
        if opt.options.get("verbose"):
            print(f"Fixer: {self.nfixed}/{opt.batch.K} nonants fixed "
                  f"at iter {opt._iter}")

    def post_everything(self, opt):
        if self._init_done and opt.options.get("verbose"):
            print(f"Fixer: final fixed count {self.nfixed}")


def __getattr__(name):
    if name == "DeviceFixer":
        raise NotImplementedError(
            "DeviceFixer (the device-side fixer over ops/shrink) is not "
            "ported yet (see ROADMAP.md A9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
