"""Fixer and DeviceFixer: WW-style iterative fixing of converged integer
nonants (the port of the JAX package's extensions/fixer.py).

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
mask. ``DeviceFixer`` runs the same pass as device ops
(ops/shrink.fixer_update) and drives active-set compaction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


class DeviceFixer(Extension):
    """The Fixer's test-and-fix as device ops over the engine's (S, K)
    state (ops/shrink.fixer_update): the per-slot counters, streaks and
    the accumulated fix mask stay on the device, and the host reads ONE
    scalar per pass (the fixed-slot count), after the PH step's
    convergence read has already waited for the arrays.

    With ``shrink_compact`` the fixed-count trajectory also drives
    :meth:`PHBase.maybe_compact`, active-set compaction at the bucketed
    thresholds.

    options (the engine's options or a dict of their own):
    ``id_fix_list_fct`` (the Fixer's contract), ``boundtol``,
    ``shrink_fix_iters`` (the threshold when no fix-list function is
    given) and ``shrink_fix_tol``."""

    def __init__(self, options=None):
        super().__init__(options)
        self._init_done = False
        self.nfixed = 0

    def reset(self):
        """Forget per-run state: counters, streaks and the latched slot
        bounds re-derive from the engine's batch on the next setup."""
        self._init_done = False
        self.nfixed = 0

    def _setup(self, opt):
        from ..ops.shrink import INT_NEVER
        fct = self.options.get("id_fix_list_fct", None)
        if fct is not None:
            spec = fct(opt.batch)
        else:
            it = int(self.options.get("shrink_fix_iters", 3))
            spec = uniform_fix_list(
                opt.batch, tol=float(self.options.get("shrink_fix_tol",
                                                      1e-4)),
                nb=it, lb=it, ub=it)
        t, dev = opt.dtype, opt.device

        def counts(a):
            return torch.as_tensor(np.minimum(np.asarray(a, np.int64),
                                              INT_NEVER), device=dev)

        self._tol = torch.as_tensor(np.asarray(spec["tol"], np.float64),
                                    dtype=t, device=dev)
        self._nbc = counts(spec["nb"])
        self._lbc = counts(spec["lb"])
        self._ubc = counts(spec["ub"])
        self._boundtol = float(self.options.get("boundtol", 1e-6))
        z = torch.zeros(opt.batch.K, dtype=torch.int64, device=dev)
        self._conv_count, self._lb_count, self._ub_count = z, z, z
        idx = np.asarray(opt.batch.nonant_idx)
        self._slot_lb = torch.as_tensor(np.asarray(opt.batch.lb)[:, idx],
                                        dtype=t, device=dev)
        self._slot_ub = torch.as_tensor(np.asarray(opt.batch.ub)[:, idx],
                                        dtype=t, device=dev)
        self._imask = torch.as_tensor(opt.nonant_integer_mask, device=dev)
        self._init_done = True

    def post_iter0(self, opt):
        if not self._init_done:
            self._setup(opt)

    def miditer(self, opt):
        from .. import obs
        from ..ops.shrink import fixer_update
        if not self._init_done:
            self._setup(opt)
        (self._conv_count, self._lb_count, self._ub_count,
         fixed_mask, fixed_vals, n_fixed) = fixer_update(
            self._conv_count, self._lb_count, self._ub_count,
            opt._fixed_mask, opt._fixed_vals, opt.xbar, opt.xsqbar,
            opt._hub_nonants(), self._slot_lb, self._slot_ub, self._tol,
            self._boundtol, self._nbc, self._lbc, self._ubc, self._imask,
            mesh=getattr(opt, "shard_mesh", None))
        # the ONE host scalar of the pass; the (S, K) mask and values
        # stay on the device (fix_nonants takes device tensors)
        nf = int(n_fixed)
        if nf > self.nfixed:
            opt.fix_nonants(fixed_vals, mask=fixed_mask)
            obs.counter_add("shrink.fixed_new", nf - self.nfixed)
            obs.gauge_set("shrink.fixed_fraction", nf / opt.batch.K)
            obs.event("shrink.fix", {"iter": opt._iter, "fixed": nf,
                                     "free": opt.batch.K - nf})
            if opt.options.get("verbose"):
                print(f"DeviceFixer: {nf}/{opt.batch.K} nonants fixed "
                      f"at iter {opt._iter}")
        self.nfixed = nf
        st = getattr(opt, "_shrink_status", None)
        if st is not None:
            st["fixed"], st["free"] = nf, opt.batch.K - nf
        opt.maybe_compact(nf)

    def post_everything(self, opt):
        if self._init_done and opt.options.get("verbose"):
            print(f"DeviceFixer: final fixed count {self.nfixed}")
