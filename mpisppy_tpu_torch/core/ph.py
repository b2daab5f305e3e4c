"""Progressive Hedging: PHBase primitives + the synchronous PH driver
(the port of mpisppy_tpu/core/ph.py, one device).

One PH iteration over the whole scenario batch runs three stages:
  1. assemble: the objective rewrite f_s(x) + w_on·Wᵀx + prox_on·ρ/2‖x−x̄‖²
     as a linear-term assembly (q = c with W − ρx̄ added in the nonant
     columns; the prox quadratic is ρ on the nonant diagonal of P, so
     prox on/off are two cached factorizations), plus nonant pinning;
  2. solve: the batched ADMM subproblem solve (ops/qp_solver, or the
     fused kernel path of ops/kernels);
  3. reduce: Compute_Xbar (membership matmuls), Update_W, convergence,
     the objectives and the certified dual bound.
The ADMM state and the factor cache persist across iterations (q is
the only thing PH changes), replacing the reference's persistent-solver
set_objective (ref. phbase.py:903).

With ``subproblem_chunk`` below S the solve microbatches over scenario
chunks that share one factor (``_solve_loop_chunked``): one solve call
per chunk, one stacked residual read per iteration for the recovery
gate, bounded chunk retries with blacklists, the per-scenario hospital,
then one global x̄/W reduction.

Precision (``subproblem_precision``): ``native`` iterates in f64;
``mixed`` runs an f32 bulk then an f64 tail; ``df32`` additionally
ships a shared A as the split-f32 pair (core/spbase), every mode shares
one equilibration and scaled split, the engine's QPData.A becomes a
ScaledView over it, and the chunked loop flows one (rho_scale, factor)
pair from chunk to chunk.

The surfaces the wheel's cylinders call: nonant fixing, fixed-mode
solves (``solve_loop(fixed=True)``: the fully pinned factorization),
incumbent evaluation (``calculate_incumbent``, the batched
``evaluate_incumbent_pool``), integer candidates
(``dive_nonant_candidates``), the hub traffic (``_hub_nonants``) and ``ph_main``'s
hub hooks (``spcomm.sync()`` after iter 0 and every iteration, the
spokes' best outer bound, hub termination).
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from .. import global_toc, obs
from ..ir.batch import ScenarioBatch
from ..ops.qp_solver import (QPData, ScaledView, SplitMatrix,
                             qp_cold_state, qp_dual_objective,
                             qp_objective, qp_reset_rho, qp_setup,
                             qp_setup_like, qp_solve_mixed,
                             qp_solve_segmented, stacked_residuals)
from ..utils.runtime import to_host
from .spbase import SPBase, batch_cache, compute_xbar

_log = logging.getLogger("mpisppy_tpu_torch.ph")

# phase -> telemetry span name
_PHASE_SPAN = {"assemble": "ph.assemble", "solve": "ph.solve",
               "gate": "ph.gate", "reduce": "ph.reduce"}


def _mode_str(key):
    """Human mode tag for telemetry span args: the solve-mode key
    ((fixed,) prox bool)."""
    if isinstance(key, tuple):
        return f"fixed+{'prox' if key[1] else 'noprox'}"
    return "prox" if key else "noprox"


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


def _ph_assemble(data, c, W, xbar, rho, idx, fixed_mask, fixed_vals,
                 wscale, *, w_on, prox_on):
    """Stage 1: objective rewrite + nonant pinning. ``wscale`` ((S, K)
    or None) scales the W term by variable/scenario probability (see
    the JAX package). Returns (q, lb, ub) as new tensors: the batch's
    own vectors are never written."""
    Weff = W if wscale is None else W * wscale
    if w_on and prox_on:
        wvec = Weff - rho * xbar
    elif w_on:
        wvec = Weff
    elif prox_on:
        wvec = -rho * xbar
    else:
        wvec = torch.zeros_like(W)
    q = c.index_add(1, idx, wvec)
    # fixed nonants: pin boxes (ref. phbase.py:413 _fix_nonants)
    bl = data.lb.index_copy(1, idx, torch.where(fixed_mask, fixed_vals,
                                                data.lb[:, idx]))
    bu = data.ub.index_copy(1, idx, torch.where(fixed_mask, fixed_vals,
                                                data.ub[:, idx]))
    return q, bl, bu


def _ph_chunk_objs(x, yA, yB, d, q, c, c0, P0, idx, W, *, w_on):
    """Objectives + certified dual bound of one solve."""
    xn = x[:, idx]
    base_obj = torch.sum(c * x, dim=1) + c0 \
        + 0.5 * torch.sum(P0 * x * x, dim=1)
    solved_obj = base_obj + (torch.sum(W * xn, dim=1) if w_on else 0.0)
    dual_obj = qp_dual_objective(d, q, c0, yA, yB, x_witness=x)
    return xn, base_obj, solved_obj, dual_obj


def _ph_combine(xn, prob, xbar_w, memberships, W, rho, wmask, *,
                slot_slices):
    """Compute_Xbar + Update_W + convergence over the nonant block."""
    K = xn.shape[1]
    xbar_new = compute_xbar(memberships, slot_slices, xbar_w, xn)
    xsqbar_new = compute_xbar(memberships, slot_slices, xbar_w, xn * xn)
    W_new = W + rho * (xn - xbar_new)
    if wmask is not None:
        W_new = torch.where(wmask, W_new, 0.0)
    conv = torch.dot(prob, torch.sum(torch.abs(xn - xbar_new), dim=1)) / K
    return xbar_new, xsqbar_new, W_new, conv


def _ph_reduce(x, yA, yB, d, q, c, c0, P0, prob, xbar_w, memberships, idx,
               W, rho, wmask, *, w_on, slot_slices):
    """Stage 3: the composition of _ph_chunk_objs and _ph_combine."""
    xn, base_obj, solved_obj, dual_obj = _ph_chunk_objs(
        x, yA, yB, d, q, c, c0, P0, idx, W, w_on=w_on)
    xbar_new, xsqbar_new, W_new, conv = _ph_combine(
        xn, prob, xbar_w, memberships, W, rho, wmask,
        slot_slices=slot_slices)
    return xn, xbar_new, xsqbar_new, W_new, conv, base_obj, solved_obj, \
        dual_obj


def _pool_assemble(lb, ub, l, u, c, c0, vals, pin_mask, idx, sidx, pidx):
    """Chunk assembly of the batched incumbent-pool evaluation: gather
    the chunk's scenario rows and pin the candidates' nonant boxes
    (l = u = x̂ on the pinned slots). Row r of a pool solve is
    (candidate pidx[r], scenario sidx[r]): the pool axis rides the
    batch axis, so the chunk is an ordinary shared-factor solve."""
    lb_c, ub_c = lb[sidx], ub[sidx]
    v = vals[pidx]                                   # (rows, K)
    lb_c = lb_c.index_copy(1, idx, torch.where(pin_mask, v, lb_c[:, idx]))
    ub_c = ub_c.index_copy(1, idx, torch.where(pin_mask, v, ub_c[:, idx]))
    return lb_c, ub_c, l[sidx], u[sidx], c[sidx], c0[sidx]


def _pool_rows_zeroed(st, keep):
    """``st`` with the warm-start iterates of the pool rows whose
    candidate came back INFEASIBLE zeroed (as new tensors): an
    infeasible solve's iterates are diverged, and zero iterates are a
    valid warm start under any rho_scale, so the factor and scale
    trajectory are kept."""
    def r(a):
        return torch.where(keep.unsqueeze(-1) if a.ndim > 1 else keep,
                           a, 0.0)
    return st._replace(x=r(st.x), yA=r(st.yA), yB=r(st.yB), zA=r(st.zA),
                       zB=r(st.zB))


def _hot_eps(prox_on, sub_eps, sub_eps_hot):
    """The effective primal tolerance of a solve."""
    return sub_eps_hot if (prox_on and sub_eps_hot is not None) else sub_eps


def _solver_call(factors, d, q, qp_state, *, prox_on, precision,
                 sub_max_iter, sub_eps, sub_eps_hot, sub_eps_dua_hot,
                 stall_rel, segment, polish_hot, polish_chunk, tail_iter=0,
                 segment_lo=None, ir_sweeps=1, kernel=None,
                 adaptive_rho=True):
    """The precision-policy + solver dispatch. Prox-on solves may use
    loosened hot-loop tolerances and skip the polish
    (subproblem_polish_hot=False); prox-off solves always polish (their
    duals certify bounds; a df32 solve has no polish). A fused
    ``kernel`` plan routes the solve through ops/kernels.kernel_solve;
    otherwise (``kernel=None``, as every chunk retry and hospital solve
    passes) the host-segmented drivers run: qp_solve_mixed for
    mixed/df32 (the f32 bulk + accurate tail; df32 differs only in the
    data representation), qp_solve_segmented for native."""
    e_pri = _hot_eps(prox_on, sub_eps, sub_eps_hot)
    e_dua = sub_eps_dua_hot if (prox_on and sub_eps_dua_hot is not None) \
        else sub_eps
    do_polish = polish_hot or not prox_on
    if kernel is not None and kernel.mode == "fused":
        from ..ops import kernels as _kernels
        return _kernels.kernel_solve(
            kernel, factors, d, q, qp_state, precision=precision,
            max_iter=sub_max_iter, tail_iter=tail_iter, e_pri=e_pri,
            e_dua=e_dua, stall_rel=stall_rel, polish=do_polish,
            polish_chunk=polish_chunk, ir_sweeps=ir_sweeps,
            adaptive_rho=adaptive_rho)
    if precision in ("mixed", "df32"):
        return qp_solve_mixed(factors, d, q, qp_state,
                              max_iter=sub_max_iter, tail_iter=tail_iter,
                              eps_abs=e_pri, eps_rel=e_pri,
                              polish_chunk=polish_chunk,
                              eps_abs_dua=e_dua, eps_rel_dua=e_dua,
                              stall_rel=stall_rel, segment=segment,
                              segment_lo=segment_lo, polish=do_polish,
                              ir_sweeps=ir_sweeps,
                              adaptive_rho=adaptive_rho)
    return qp_solve_segmented(factors, d, q, qp_state,
                              max_iter=sub_max_iter, segment=segment,
                              eps_abs=e_pri, eps_rel=e_pri,
                              polish_chunk=polish_chunk,
                              eps_abs_dua=e_dua, eps_rel_dua=e_dua,
                              stall_rel=stall_rel, polish=do_polish,
                              ir_sweeps=ir_sweeps,
                              adaptive_rho=adaptive_rho)


def _ph_step(qp_state, factors, data, c, c0, P0, prob, xbar_w, memberships,
             idx, W, xbar, rho, fixed_mask, fixed_vals, wscale=None, *,
             w_on, prox_on, slot_slices, sub_max_iter, sub_eps,
             polish_chunk, precision="native", tail_iter=1000,
             sub_eps_hot=None, sub_eps_dua_hot=None, stall_rel=0.0,
             segment=500, polish_hot=True, segment_lo=None, ir_sweeps=1,
             lap=None, kernel=None):
    """The PH iteration: assemble, batched solve, reduce."""
    q, bl, bu = _ph_assemble(data, c, W, xbar, rho, idx, fixed_mask,
                             fixed_vals, wscale, w_on=w_on,
                             prox_on=prox_on)
    d = data._replace(lb=bl, ub=bu)
    if lap is not None:
        lap("assemble")
    qp_state, x, yA, yB = _solver_call(
        factors, d, q, qp_state, prox_on=prox_on, precision=precision,
        sub_max_iter=sub_max_iter, sub_eps=sub_eps,
        sub_eps_hot=sub_eps_hot, sub_eps_dua_hot=sub_eps_dua_hot,
        stall_rel=stall_rel, segment=segment, polish_hot=polish_hot,
        polish_chunk=polish_chunk, tail_iter=tail_iter,
        segment_lo=segment_lo, ir_sweeps=ir_sweeps, kernel=kernel)
    if kernel is not None and kernel.mode == "fused" and obs.enabled():
        obs.counter_add("kernel.fused_iters", int(qp_state.iters))
    if lap is not None:
        lap("solve")
    wmask = None if wscale is None else wscale > 0
    (xn, xbar_new, xsqbar_new, W_new, conv, base_obj, solved_obj,
     dual_obj) = _ph_reduce(x, yA, yB, d, q, c, c0, P0, prob, xbar_w,
                            memberships, idx, W, rho, wmask, w_on=w_on,
                            slot_slices=slot_slices)
    if lap is not None:
        lap("reduce")
    return qp_state, x, yA, yB, xn, xbar_new, xsqbar_new, W_new, \
        conv, base_obj, solved_obj, dual_obj


class _ChunkStateView:
    """Lazy concatenated view over per-chunk QPStates, stored at
    ``_qp_states[key]`` in chunked mode. The state consumers (iter-0
    feasibility checks, residual summaries, warm-start transplants)
    read it occasionally, so a field is concatenated on first access,
    pad rows trimmed, and cached on the instance. The per-chunk states
    stay authoritative for warm starts.

    Every field has its QPState meaning: x, yA, yB are the SCALED
    iterates, as zA, zB are. (The JAX package's view holds the unscaled
    solutions under x, yA, yB beside scaled zA, zB, so a new mode's
    chunk states transplant a mix of the two; ROADMAP.md C.2.)"""

    _FIELDS = ("x", "yA", "yB", "zA", "zB", "pri_res", "dua_res",
               "pri_rel", "dua_rel")

    def __init__(self, states, trims):
        self._states = list(states)
        self._trims = list(trims)

    def __getattr__(self, name):
        if name in _ChunkStateView._FIELDS:
            val = torch.cat([getattr(s, name)[:r]
                             for s, r in zip(self._states, self._trims)])
            setattr(self, name, val)
            return val
        raise AttributeError(name)


def _set_row(t, r, v):
    """``t`` with row ``r`` replaced by ``v``, as a new tensor: chunk
    records may share buffers with sibling chunks, so no row is ever
    written in place."""
    return t.index_copy(0, torch.tensor([r], device=t.device),
                        v.unsqueeze(0))


class PHBase(SPBase):
    def __init__(self, batch: ScenarioBatch, options=None, rho_setter=None,
                 extensions=None, converger=None, dtype=None, device=None,
                 mesh=None):
        if mesh is not None:
            raise _not_ported("the scenario-axis device mesh")
        super().__init__(batch, options, dtype, device=device)
        opts = self.options
        self.rho_default = float(opts.get("defaultPHrho", 1.0))
        self.max_iterations = int(opts.get("PHIterLimit", 100))
        self.convthresh = float(opts.get("convthresh", 1e-4))
        self.verbose = bool(opts.get("verbose", False))
        self.sub_max_iter = int(opts.get("subproblem_max_iter", 5000))
        self.sub_eps = float(opts.get("subproblem_eps", 1e-8))
        # "native": solve at self.dtype; "mixed": f32 bulk + f64 tail;
        # "df32": mixed over the split-f32 A (core/spbase)
        self.sub_precision = str(opts.get("subproblem_precision", "native"))
        if self.sub_precision not in ("native", "mixed", "df32"):
            raise ValueError(f"unknown subproblem_precision "
                             f"{self.sub_precision!r}")
        # the mixed/df32 tail budget; native precision reads it only for
        # the chunk-retry budget (as the JAX package does)
        self.sub_tail_iter = int(opts.get("subproblem_tail_iter", 1000))
        _h = opts.get("subproblem_eps_hot", None)
        self.sub_eps_hot = None if _h is None else float(_h)
        _hd = opts.get("subproblem_eps_dua_hot", None)
        self.sub_eps_dua_hot = None if _hd is None else float(_hd)
        self.sub_stall_rel = float(opts.get("subproblem_stall_rel", 0.0))
        self.sub_segment = int(opts.get("subproblem_segment", 500))
        # the f32 bulk's segment of the segmented mixed driver
        _sl = opts.get("subproblem_segment_lo", None)
        self.sub_segment_lo = None if _sl is None else int(_sl)
        self.sub_ir_sweeps = int(opts.get("subproblem_ir_sweeps", 1))
        self.sub_polish_hot = bool(opts.get("subproblem_polish_hot", True))
        self.sub_polish_chunk = int(opts.get("subproblem_polish_chunk", 0))
        from ..utils.config import (FUSED_IR_SWEEPS, KERNEL_BACKENDS,
                                    KERNEL_BLOCK_DTYPES,
                                    KERNEL_L_INV_MODES, KERNEL_MODES)
        self.sub_kernel_mode = str(opts.get("subproblem_kernel_mode",
                                            "auto"))
        self.sub_kernel_backend = str(opts.get("subproblem_kernel_backend",
                                               "reference"))
        self.sub_kernel_l_inv = str(opts.get("subproblem_kernel_l_inv",
                                             "auto"))
        block_dtype = str(opts.get("subproblem_kernel_block_dtype",
                                   "auto"))
        for val, known, name in (
                (self.sub_kernel_mode, KERNEL_MODES, "mode"),
                (self.sub_kernel_backend, KERNEL_BACKENDS, "backend"),
                (self.sub_kernel_l_inv, KERNEL_L_INV_MODES, "l_inv"),
                (block_dtype, KERNEL_BLOCK_DTYPES, "block_dtype")):
            if val not in known:
                raise ValueError(f"unknown subproblem_kernel_{name} "
                                 f"{val!r}; known: {known}")
        if block_dtype == "bf16":
            # the bulk's packed blocks stay f32 ("auto" and "f32")
            raise _not_ported("bf16 packed blocks for the mixed/df32 bulk")
        if self.sub_kernel_mode == "fused" \
                and self.sub_ir_sweeps not in FUSED_IR_SWEEPS:
            raise ValueError(
                f"subproblem_kernel_mode='fused' supports "
                f"subproblem_ir_sweeps in [{FUSED_IR_SWEEPS.start}, "
                f"{FUSED_IR_SWEEPS.stop - 1}]; got {self.sub_ir_sweeps}")
        if self.sub_precision in ("mixed", "df32") \
                and self.dtype != torch.float64:
            raise ValueError(f"subproblem_precision={self.sub_precision!r}"
                             f" needs dtype=float64; got {self.dtype}")
        if opts.get("shrink_fix") or opts.get("shrink_compact") \
                or opts.get("shrink_rho"):
            with_prec = "" if self.sub_precision == "native" else \
                f" with subproblem_precision={self.sub_precision!r}"
            raise _not_ported("problem shrinking" + with_prec)
        self._kernel_plans = {}
        # ADMM block launches of plans already dropped (the live plans
        # book their own; kernel_launches sums both)
        self._retired_launches = 0
        self.rho_setter = rho_setter
        self.extensions = extensions
        self.converger_cls = converger
        self.converger = None

        S, K = batch.S, batch.K
        t, dev = self.dtype, self.device
        if rho_setter is not None:
            rho0 = np.broadcast_to(np.asarray(rho_setter(batch),
                                              dtype=np.float64), (K,))
        else:
            rho0 = np.full(K, self.rho_default)
        self.rho = torch.as_tensor(np.broadcast_to(rho0, (S, K)).copy(),
                                   dtype=t).to(dev)
        self.W = torch.zeros((S, K), dtype=t, device=dev)
        self.xbar = torch.zeros((S, K), dtype=t, device=dev)
        self.xsqbar = torch.zeros((S, K), dtype=t, device=dev)
        self._w_scale = None
        self.x = None
        self.conv = None
        self._iter = 0
        self.best_bound = -float("inf")
        self._factors = {}       # prox_on -> (QPFactors, QPData)
        # df32: the first mode's split factors, whose equilibration and
        # scaled split every later mode shares (qp_setup_like)
        self._split_base = None
        # prox_on -> QPState (a _ChunkStateView in chunked mode)
        self._qp_states = {}
        # prox_on -> the per-chunk QPStates of chunked mode
        self._chunk_states = {}
        # mode key -> the full-width row store of dispatch-masked passes
        # (_dispatch_store)
        self._dispatch_stores = {}
        self._fixed_mask = torch.zeros((S, K), dtype=torch.bool,
                                       device=dev)
        self._fixed_vals = torch.zeros((S, K), dtype=t, device=dev)
        # chunked-loop bookkeeping (see _solve_loop_chunked), per mode
        # key: chunks whose reset-rho retry did not help, and global
        # scenario ids the hospital failed to improve. Both lists are
        # cleared every ``subproblem_blacklist_readmit`` solves of the
        # mode (_blacklist_calls counts them): q moves every PH
        # iteration, so a row incurable at iteration k may be easy later
        self._chunk_no_retry = {}
        self._hospital_no_retry = {}
        self._blacklist_calls = {}
        self._chunk_idx_cache = {}
        self._phase_times = {}
        # batched incumbent-pool evaluation: per-(pool, chunk) warm
        # states (see evaluate_incumbent_pool)
        self._pool_states = {}

    @property
    def kernel_launches(self) -> int:
        """ADMM block launches made by this engine (cuda backend)."""
        return self._retired_launches + sum(
            p.launches for p in self._kernel_plans.values())

    # ------------- observability plumbing -------------
    def _trace_note(self, etype, msg, **fields):
        """A recovery/hospital/standing note: a telemetry event, the
        ``mpisppy_tpu_torch.ph`` logger, and the screen when ``verbose``
        or ``hospital_trace`` is set."""
        obs.event(etype, fields)
        _log.info(msg)
        if self.verbose or bool(self.options.get("hospital_trace",
                                                 False)):
            global_toc(msg)

    def _trace_consumers_active(self):
        """Whether anything would consume a note: the gate for host math
        done only to narrate."""
        return (self.verbose
                or bool(self.options.get("hospital_trace", False))
                or obs.enabled() or _log.isEnabledFor(logging.INFO))

    # ------------- solver plumbing -------------
    def _data_with_prox(self, prox_on: bool) -> QPData:
        if not prox_on:
            return self.qp_data
        d = self.qp_data
        idx = self.nonant_idx
        if d.P_diag.ndim == 1:
            # shared-structure batch: the prox diagonal stays shared for
            # the single-factor form whenever rho is uniform across
            # scenarios (the default; rho setters are per slot)
            if bool((self.rho == self.rho[:1]).all()):
                return d._replace(P_diag=d.P_diag.index_add(0, idx,
                                                            self.rho[0]))
            # per-scenario rho: the batched (S, m, n) representation
            # (outside the ADMM block's scope, which needs a 2-D A)
            if isinstance(d.A, (SplitMatrix, ScaledView)):
                raise ValueError(
                    "per-scenario rho needs the batched (S, m, n) "
                    "representation, which the df32 SplitMatrix cannot "
                    "broadcast to — use a uniform rho with "
                    "subproblem_precision='df32'")
            S = self.batch.S
            P = d.P_diag.expand(S, -1).index_add(1, idx, self.rho)
            return d._replace(P_diag=P, A=d.A.expand((S,) + d.A.shape))
        return d._replace(P_diag=d.P_diag.index_add(1, idx, self.rho))

    def _get_factors(self, prox_on: bool, fixed: bool = False,
                     full: bool = False):
        """Cached per-mode factorization (invalidated on rho change).

        ``fixed=True`` builds factors for fully-pinned-nonant solves
        (incumbent evaluation): the nonant boxes become equalities
        there, and the ADMM bound-row rho must be eq-boosted for those
        columns or the solve crawls. The boost pattern depends only on
        WHICH columns are pinned, not the values, so one factorization
        serves every candidate x̂. ``full`` is the JAX package's bypass
        of an active shrink plan; the port has no shrinking, so every
        factorization is full.

        Each mode runs its own setup (equilibration + scaled matrix),
        except in df32: there every mode, and every engine over the
        same batch (the batch device cache, core/spbase), shares ONE
        equilibration and scaled split (qp_setup_like over the base
        factors), since another (m, n) split pair per mode or engine
        would cost gigabytes at the scale the representation exists
        for; the engine's raw split A is swapped for a ScaledView over
        the scaled one, so the raw pair frees. The cached tensors are
        never written in place."""
        key = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        if key not in self._factors:
            d = self._data_with_prox(prox_on)
            d_setup = d
            if fixed:
                # pin the boxes only for the rho-pattern detection; the
                # cached data stays unpinned (the step applies
                # fixed_vals through fixed_mask at solve time)
                idx = self.nonant_idx
                d_setup = d._replace(lb=d.lb.index_fill(1, idx, 0.0),
                                     ub=d.ub.index_fill(1, idx, 0.0))
            is_split = isinstance(self.qp_data.A, (SplitMatrix, ScaledView))
            base = self._split_base
            if base is not None:
                fac = qp_setup_like(base, d_setup)
            elif is_split:
                # cross-ENGINE sharing of the base, serialized under the
                # batch cache's lock (cylinder threads build factors on
                # their first solves)
                cache, lock = batch_cache(self.batch)
                with lock:
                    bkey = ("factors_base", str(self.dtype),
                            str(self.device))
                    base = cache.get(bkey)
                    if base is not None:
                        fac = qp_setup_like(base, d_setup)
                    else:
                        fac = base = qp_setup(d_setup, q_ref=self.c)
                        cache[bkey] = fac
                        # from here on every engine reads A through the
                        # scaled view; the raw pair frees once the last
                        # engine's qp_data drops it
                        cache[("A", str(self.dtype), str(self.device),
                               True)] = ScaledView(fac.A_s, fac.D, fac.E)
                self._split_base = base
            else:
                fac = qp_setup(d_setup, q_ref=self.c)
            if isinstance(fac.A_s, SplitMatrix) \
                    and isinstance(self.qp_data.A, SplitMatrix):
                view = ScaledView(fac.A_s, fac.D, fac.E)
                self.qp_data = self.qp_data._replace(A=view)
                d = d._replace(A=view)
            self._factors[key] = (fac, d)
        return self._factors[key]

    def _kernel_plan(self, key, factors, s_chunk=None):
        """Cached ops/kernels plan for one mode's factors (invalidated
        with them). ``s_chunk`` (rows per solve call, default S) enters
        the L⁻¹ verdict of mixed/df32; a mode's calls always have one
        row count (chunked or not is fixed per engine), so the mode key
        suffices."""
        plan = self._kernel_plans.get(key)
        if plan is None:
            s_chunk = self.batch.S if s_chunk is None else s_chunk
            from ..ops import kernels
            tail = self.sub_tail_iter \
                if self.sub_precision in ("mixed", "df32") else 0
            plan = kernels.prepare(
                factors, mode=self.sub_kernel_mode,
                backend=self.sub_kernel_backend,
                l_inv=self.sub_kernel_l_inv,
                precision=self.sub_precision, tail_iter=tail,
                ir_sweeps=self.sub_ir_sweeps, s_chunk=s_chunk)
            self._kernel_plans[key] = plan
        return plan

    def invalidate_factors(self):
        """Call after changing rho: drops the prox-on factors (fixed
        mode's too), plans and solver states (chunked ones included); a
        new rho also earns every blacklisted chunk and scenario a fresh
        recovery chance."""
        self._retired_launches = self.kernel_launches
        self._kernel_plans.clear()
        for cache in (self._factors, self._qp_states, self._chunk_states,
                      self._dispatch_stores):
            cache.pop(True, None)
            cache.pop(("fixed", True), None)
        self._pool_states.clear()
        self._chunk_no_retry.clear()
        self._hospital_no_retry.clear()
        self._blacklist_calls.clear()
        self._chunk_idx_cache.clear()

    def _ensure_state(self, prox_on=True, fixed=False):
        """Per-mode solver state (the KKT factor depends on the prox
        term and, for ``fixed``, the pinned columns); x/y/z warm-start
        across modes. Always a QPState: a chunked mode's concatenated
        view is materialized (fresh factor, the view's iterates as warm
        start)."""
        key = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        st = self._qp_states.get(key)
        if isinstance(st, _ChunkStateView):
            factors, d = self._get_factors(prox_on, fixed)
            st = qp_cold_state(factors, d)._replace(
                x=st.x, yA=st.yA, yB=st.yB, zA=st.zA, zB=st.zB)
            self._qp_states[key] = st
            return st
        if key not in self._qp_states:
            factors, d = self._get_factors(prox_on, fixed)
            st = qp_cold_state(factors, d)
            other = self._warm_source(key)
            if other is not None and other.x.shape == st.x.shape \
                    and other.zA.shape == st.zA.shape:
                st = st._replace(x=other.x, yA=other.yA, yB=other.yB,
                                 zA=other.zA, zB=other.zB)
            self._qp_states[key] = st
        return self._qp_states[key]

    def _warm_source(self, exclude=None):
        """The first cached state (QPState or chunk view) of a mode other
        than ``exclude``: a new state's warm start."""
        return next((v for k, v in self._qp_states.items()
                     if k != exclude), None)

    # ------------- scenario microbatching -------------
    def _chunk_index(self, chunk):
        """Per-chunk (scenario index tensor, real row count), every index
        exactly ``chunk`` long: an uneven final chunk is padded by
        repeating its last scenario, so every solve call has one shape.
        The duplicate rows solve redundantly and are trimmed before any
        reduction. Keyed by (chunk, S) so a mutated batch never reuses
        stale slices."""
        S = self.batch.S
        if (chunk, S) not in self._chunk_idx_cache:
            out = []
            for i in range(0, S, chunk):
                idx = np.arange(i, min(i + chunk, S))
                real = idx.size
                if real < chunk:
                    idx = np.concatenate(
                        [idx, np.full(chunk - real, idx[-1])])
                out.append((torch.as_tensor(idx, dtype=torch.long,
                                            device=self.device), real))
            self._chunk_idx_cache[(chunk, S)] = out
        return self._chunk_idx_cache[(chunk, S)]

    def _ensure_chunk_states(self, key, factors, data, slices):
        """Per-chunk QPStates, the authoritative store of chunked mode
        (each chunk owns its rho_scale / factor trajectory). ONE cold
        state serves every chunk, factor included: chunk shapes are
        identical and nothing on the chunked path writes a state's
        tensors in place, so the sharing is safe. A new mode transplants
        its iterates from another mode's (concatenated) state, as
        _ensure_state does."""
        if key not in self._chunk_states:
            # any mode's state, this mode's own included (as the JAX
            # package reads it)
            other = self._warm_source()
            idx0 = slices[0][0]
            d0 = data._replace(l=data.l[idx0], u=data.u[idx0],
                               lb=data.lb[idx0], ub=data.ub[idx0])
            st0 = qp_cold_state(factors, d0)
            transplant = other is not None \
                and other.x.shape[0] == self.batch.S \
                and other.zA.shape[1] == st0.zA.shape[1] \
                and other.x.shape[-1] == st0.x.shape[-1]
            states = []
            for idx, _ in slices:
                st = st0
                if transplant:
                    st = st._replace(x=other.x[idx], yA=other.yA[idx],
                                     yB=other.yB[idx], zA=other.zA[idx],
                                     zB=other.zB[idx])
                states.append(st)
            self._chunk_states[key] = states
        return self._chunk_states[key]

    def _dispatch_store(self, key, factors, data, slices):
        """Full-width per-scenario solver-state store of dispatch-masked
        passes (APH φ-dispatch). The positional per-chunk states of a
        full pass cannot warm-start a layout that re-partitions every
        iteration, so partial passes keep ONE (S, ·) row store: chunk
        states gather their rows on the way in and the successors
        scatter back after pass 3. Seeded from the mode's chunk states
        (their scaled iterates, trimmed of chunk pads), or cold zeros
        when there are none. The store carries one (L, rho_scale), the
        last chunk's (chunking needs a shared A, so L is (n, n))."""
        st = self._dispatch_stores.get(key)
        S = self.batch.S
        if st is not None and st.x.shape[0] == S:
            return st
        chunk_states = self._chunk_states.get(key)
        if chunk_states:
            cw = chunk_states[0].x.shape[0]
            trims = [r for _, r in self._chunk_index(cw)]
            st = chunk_states[-1]._replace(**{
                f: torch.cat([getattr(s, f)[:r]
                              for s, r in zip(chunk_states, trims)])
                for f in _ChunkStateView._FIELDS})
        else:
            idx0 = slices[0][0]
            d0 = data._replace(l=data.l[idx0], u=data.u[idx0],
                               lb=data.lb[idx0], ub=data.ub[idx0])
            st0 = qp_cold_state(factors, d0)
            st = st0._replace(**{
                f: torch.zeros((S,) + getattr(st0, f).shape[1:],
                               dtype=getattr(st0, f).dtype,
                               device=self.device)
                for f in _ChunkStateView._FIELDS})
        self._dispatch_stores[key] = st
        return st

    def _dispatch_slices(self, dispatch, chunk, key):
        """(slices, padded ids) of a dispatch-masked pass: the ascending
        id list microbatched into full ``chunk``-row chunks, the last
        padded by repeating the last id (the _chunk_index convention).
        Books the dispatch counters and the shape bucket."""
        from ..ops import dispatch as dispatch_ops
        didx = np.asarray(dispatch, dtype=np.int64).ravel()
        scnt = int(didx.size)
        if scnt == 0:
            raise ValueError("dispatch id list is empty")
        n_dchunks = -(-scnt // chunk)
        pad_n = n_dchunks * chunk - scnt
        ids_pad = np.concatenate([didx, np.full(pad_n, didx[-1])]) \
            if pad_n else didx
        slices = [(torch.as_tensor(ids_pad[i * chunk:(i + 1) * chunk],
                                   device=self.device),
                   min(chunk, scnt - i * chunk))
                  for i in range(n_dchunks)]
        dispatch_ops.register_bucket({
            "n_chunks": n_dchunks, "chunk": chunk, "S": self.batch.S,
            "mode": _mode_str(key)})
        obs.counter_add("dispatch.solved_scenarios", scnt)
        obs.counter_add("dispatch.skipped_scenarios",
                        max(self._S_orig - scnt, 0))
        return slices, ids_pad

    # ------------- the PH step -------------
    def solve_loop(self, w_on=True, prox_on=True, update=True, fixed=False,
                   dispatch=None):
        """One batched solve pass in the given mode (ref. phbase.py:999
        solve_loop) + Compute_Xbar + Update_W. Returns the per-scenario
        solved objective (with the W term when w_on). ``fixed=True``
        selects the eq-boosted factorization for fully-pinned solves.
        With ``subproblem_chunk`` below S the solve microbatches over
        scenario chunks (_solve_loop_chunked).

        ``dispatch`` (host int array of ascending scenario ids, APH's
        φ-dispatch): solve ONLY those scenarios. The ids microbatch into
        full-size chunks and scatter back; every other scenario's
        solution, duals, warm state and objectives carry forward
        unchanged. Chunked loop only, and without the W/x̄ update (the
        caller owns the reduction over a partial solve)."""
        obs.counter_add("ph.solve_loop_calls")
        chunk = int(self.options.get("subproblem_chunk", 0) or 0)
        chunked = 0 < chunk < self.batch.S
        if dispatch is not None:
            if not chunked:
                raise ValueError(
                    "dispatch-masked solves require the chunked loop "
                    "(subproblem_chunk below S); other engines use "
                    "masked acceptance")
            if update:
                raise ValueError(
                    "dispatch-masked solves cannot run the W/xbar "
                    "update: the reduction would mix fresh and stale "
                    "rows (APH owns its own reduce)")
        if chunked:
            return self._solve_loop_chunked(chunk, w_on, prox_on, update,
                                            fixed, dispatch=dispatch)
        qp_state = self._ensure_state(prox_on, fixed)
        factors, data = self._get_factors(prox_on, fixed)
        skey = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        ent = self._phase_times.setdefault(
            skey, {"acc": {"assemble": 0.0, "solve": 0.0, "gate": 0.0,
                           "reduce": 0.0},
                   "calls": 0, "gate_syncs": 0, "devices": 1,
                   "mode": "host"})
        ent["calls"] += 1
        plan = self._kernel_plan(skey, factors)
        ent["kernel"] = plan.descriptor()
        acc = ent["acc"]
        t_mark = _time.perf_counter()

        def _lap(phase):
            nonlocal t_mark
            now = _time.perf_counter()
            acc[phase] += now - t_mark
            obs.complete_span(_PHASE_SPAN[phase], t_mark, now, cat="ph")
            t_mark = now

        (qp_state, x, yA, yB, xn, xbar_new, xsqbar_new, W_new, conv,
         base_obj, solved_obj, dual_obj) = _ph_step(
            qp_state, factors, data, self.c, self.c0, self.P_diag,
            self.prob, self.xbar_weights, tuple(self.memberships),
            self.nonant_idx, self.W, self.xbar, self.rho,
            self._fixed_mask, self._fixed_vals, self._w_scale,
            w_on=bool(w_on), prox_on=bool(prox_on),
            slot_slices=self.slot_bounds,
            sub_max_iter=self.sub_max_iter, sub_eps=self.sub_eps,
            polish_chunk=self.sub_polish_chunk,
            precision=self.sub_precision, tail_iter=self.sub_tail_iter,
            sub_eps_hot=self.sub_eps_hot,
            sub_eps_dua_hot=self.sub_eps_dua_hot,
            stall_rel=self.sub_stall_rel, segment=self.sub_segment,
            polish_hot=self.sub_polish_hot,
            segment_lo=self.sub_segment_lo, ir_sweeps=self.sub_ir_sweeps,
            lap=_lap, kernel=plan)
        self._qp_states[skey] = qp_state
        self.x, self.yA, self.yB = x, yA, yB
        if update:
            self.xbar, self.xsqbar = xbar_new, xsqbar_new
            self.W_new = W_new
            # the per-iteration convergence scalar: the one designed sync
            self.conv = float(conv)
            obs.gauge_set("ph.conv", self.conv)
        self._last_base_obj = base_obj
        self._last_solved_obj = solved_obj
        self._last_dual_obj = dual_obj
        self._ext("post_solve")
        return solved_obj

    def _solve_loop_chunked(self, chunk, w_on, prox_on, update,
                            fixed=False, dispatch=None):
        """Scenario microbatching: S scenarios solved in ceil(S/chunk)
        shared-factor solve calls, then one global membership reduce.
        Needs shared structure (one A and P for every scenario: the
        representation that makes single-factor chunking exact).

        Pipelined (default; ``subproblem_pipeline=0`` is the plain
        sequential loop):
         - ASSEMBLE: every chunk's (q, bounds) is formed up front;
         - SOLVE: one solve call per chunk (on the fused ``cuda``
           backend, one hand-written ADMM block call per chunk);
         - GATE: the recovery and hospital decisions read ONE stacked
           residual matrix, a single device-to-host copy per call
           instead of one blocking read per chunk;
         - pass 2 retries a chunk far above the gate once from a reset
           rho (segmented, native precision) and blacklists it when
           that does not help; pass 2b sends the scenarios still above
           it to the hospital (_hospitalize); pass 3 computes the
           objectives and the certified dual bound per chunk on the
           accepted solutions and runs one global x̄/W reduction.
        Per-phase wall-clock and gate syncs land in ``phase_timing()``.

        A dispatch-masked pass (``dispatch``, see solve_loop) runs the
        same passes over chunks of the dispatched ids only, with chunk
        states gathered from the mode's full-width row store
        (_dispatch_store), and scatters the results back into the store,
        x/yA/yB and the objective vectors instead of reducing."""
        key = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        factors, data = self._get_factors(prox_on, fixed)
        if dispatch is None:
            # a full-width pass supersedes this mode's dispatch store (a
            # later partial pass re-seeds it from the chunk states)
            self._dispatch_stores.pop(key, None)
        if factors.A_s.ndim != 2:
            raise ValueError(
                "subproblem_chunk requires a shared-structure batch "
                "(every scenario must carry the same A and P; "
                "per-scenario matrices need per-scenario factors and "
                "gain nothing from chunking)")
        if dispatch is None:
            slices = self._chunk_index(chunk)
            states = self._ensure_chunk_states(key, factors, data, slices)
        else:
            from ..ops.dispatch import gather_rows
            slices, ids_pad = self._dispatch_slices(dispatch, chunk, key)
            dstore = self._dispatch_store(key, factors, data, slices)
            states = [dstore._replace(**{
                f: gather_rows(getattr(dstore, f), idx)
                for f in _ChunkStateView._FIELDS}) for idx, _ in slices]
        plan = self._kernel_plan(key, factors, chunk)
        split_mode = isinstance(factors.A_s, SplitMatrix)
        kw = dict(prox_on=bool(prox_on), precision=self.sub_precision,
                  sub_max_iter=self.sub_max_iter, sub_eps=self.sub_eps,
                  sub_eps_hot=self.sub_eps_hot,
                  sub_eps_dua_hot=self.sub_eps_dua_hot,
                  tail_iter=self.sub_tail_iter,
                  stall_rel=self.sub_stall_rel, segment=self.sub_segment,
                  polish_hot=self.sub_polish_hot,
                  polish_chunk=self.sub_polish_chunk,
                  segment_lo=self.sub_segment_lo,
                  ir_sweeps=self.sub_ir_sweeps, kernel=plan)
        pipeline = bool(int(self.options.get("subproblem_pipeline", 1)))
        ent = self._phase_times.setdefault(
            key, {"acc": {"assemble": 0.0, "solve": 0.0, "gate": 0.0,
                          "reduce": 0.0},
                  "calls": 0, "gate_syncs": 0, "devices": 1,
                  "mode": "host"})
        acc = ent["acc"]
        ent["calls"] += 1
        ent["kernel"] = plan.descriptor()
        gate_syncs = 0
        sp_args = {"mode": _mode_str(key)} if obs.enabled() else None
        t_mark = _time.perf_counter()

        def _lap(phase):
            nonlocal t_mark
            now = _time.perf_counter()
            acc[phase] += now - t_mark
            obs.complete_span(_PHASE_SPAN[phase], t_mark, now, cat="ph",
                              args=sp_args)
            t_mark = now

        # record layout (indices 0-3 are the _hospitalize contract):
        #  [st, x, yA, yB, d_c, q_c, factors]
        def _assemble(ci):
            idx_c, _ = slices[ci]
            d_c = data._replace(l=data.l[idx_c], u=data.u[idx_c],
                                lb=data.lb[idx_c], ub=data.ub[idx_c])
            ws = None if self._w_scale is None else self._w_scale[idx_c]
            q_c, bl_c, bu_c = _ph_assemble(
                d_c, self.c[idx_c], self.W[idx_c], self.xbar[idx_c],
                self.rho[idx_c], self.nonant_idx,
                self._fixed_mask[idx_c], self._fixed_vals[idx_c], ws,
                w_on=bool(w_on), prox_on=bool(prox_on))
            return d_c._replace(lb=bl_c, ub=bu_c), q_c

        inputs = [_assemble(ci) for ci in range(len(slices))] \
            if pipeline else None
        _lap("assemble")

        # pass 1 — SOLVE
        solved_chunks = [None] * len(slices)
        prev_st = None
        for ci in range(len(slices)):
            if pipeline:
                d_c, q_c = inputs[ci]
            else:
                # sequential opt-out: assembly stays on the critical
                # path, but books under "assemble" (t_mark advances)
                t_a = _time.perf_counter()
                d_c, q_c = _assemble(ci)
                dt_a = _time.perf_counter() - t_a
                acc["assemble"] += dt_a
                t_mark += dt_a
            st_in = states[ci]
            if split_mode and prev_st is not None:
                # df32: chunks FLOW one (rho_scale, factor) pair through
                # the sequential loop, each chunk inheriting the previous
                # chunk's adapted stepsize, instead of holding a private
                # (n, n) factor per chunk. rho is a stepsize: iterates
                # warm-start across scale changes.
                st_in = st_in._replace(L=prev_st.L,
                                       rho_scale=prev_st.rho_scale)
            t_c = _time.perf_counter()
            st, x, yA, yB = _solver_call(factors, d_c, q_c, st_in, **kw)
            if obs.enabled():
                obs.complete_span(
                    "ph.solve.chunk", t_c, _time.perf_counter(),
                    cat="ph", args={"chunk": ci, "mode": sp_args["mode"],
                                    "devices": 1})
            prev_st = st
            if split_mode:
                # record a STRIPPED state: each chunk's factor kept until
                # pass 3 would pin every refactorized copy at once (the
                # unify below re-attaches the flowed one)
                st = st._replace(L=None)
            solved_chunks[ci] = [st, x, yA, yB, d_c, q_c, factors]
        if plan.mode == "fused":
            # phase honesty: fused solves never block mid-solve, so
            # without one wait here the device time would book under
            # "gate" (its first read). Every chunk is already enqueued:
            # one synchronize, no transfer
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if obs.enabled():
                obs.counter_add(
                    "kernel.fused_iters",
                    sum(int(rec[0].iters) for rec in solved_chunks))
        _lap("solve")
        # pass 2 — bounded recovery of chunks far above the gate
        thr = max(100 * _hot_eps(bool(prox_on), self.sub_eps, self.sub_eps_hot),
                  1e-2)
        # THE GATE: every recovery/hospital/standing decision below
        # reads this host copy of every chunk's pri_rel (kept current by
        # the retries and the hospital)
        if pipeline:
            pri_host = stacked_residuals(
                [rec[0] for rec in solved_chunks]).cpu().numpy().copy()
            gate_syncs += 1
        else:
            pri_host = np.stack([rec[0].pri_rel.cpu().numpy()
                                 for rec in solved_chunks])
            gate_syncs += len(solved_chunks)
        if obs.enabled():
            obs.counter_add("xfer.d2h_bytes", pri_host.nbytes)
        # blacklist re-admission every ``readmit`` solves of this mode
        readmit = int(self.options.get("subproblem_blacklist_readmit", 16))
        calls = self._blacklist_calls[key] = \
            self._blacklist_calls.get(key, 0) + 1
        if readmit and calls % readmit == 0 and (
                self._chunk_no_retry.get(key)
                or self._hospital_no_retry.get(key)):
            nb = len(self._chunk_no_retry.get(key, ())) \
                + len(self._hospital_no_retry.get(key, ()))
            self._chunk_no_retry.pop(key, None)
            self._hospital_no_retry.pop(key, None)
            obs.counter_add("ph.blacklist_readmitted", nb)
            self._trace_note(
                "ph.blacklist_readmit",
                f"blacklist: re-admitting {nb} entr"
                f"{'y' if nb == 1 else 'ies'} for recovery "
                f"(every {readmit} solves)", count=nb, every=readmit)
        no_retry = self._chunk_no_retry.setdefault(key, set())
        for ci, rec in enumerate(solved_chunks):
            m = float(pri_host[ci].max())
            is_nan = not np.isfinite(m)
            # the blacklist stops repeated retries of a hard chunk, but
            # NaN iterates are always replaced: stored, they would
            # poison every later warm start
            if (m <= thr) or (ci in no_retry and not is_nan):
                continue
            fac_c, d_r, q_r = rec[6], rec[4], rec[5]
            if is_nan:
                # the iterates themselves are poison: restart cold
                st_r = qp_cold_state(fac_c, d_r)
            else:
                # plateaued far out: keep the iterates, reset the
                # stepsize trajectory
                st_r = qp_reset_rho(fac_c, rec[0])
            # the retry runs segmented (kernel=None) in native precision
            # with a budget at least the original solve's
            kw_r = dict(kw, precision="native", kernel=None,
                        sub_max_iter=max(kw["sub_max_iter"]
                                         + 4 * kw["tail_iter"], 1500))
            st2, x2, yA2, yB2 = _solver_call(fac_c, d_r, q_r, st_r,
                                             **kw_r)
            pri2 = st2.pri_rel.cpu().numpy()   # the retry's own sync
            gate_syncs += 1
            if obs.enabled():
                obs.counter_add("xfer.d2h_bytes", pri2.nbytes)
            m2 = float(pri2.max())
            obs.counter_add("ph.chunk_retries")
            obs.event("ph.chunk_retry",
                      {"chunk": ci, "nan": is_nan, "pri_rel_before": m,
                       "pri_rel_after": m2})
            if split_mode:
                # retry factors are transient too (see the pass-1 strip)
                st2 = st2._replace(L=None)
                st_r = st_r._replace(L=None)
            if np.isfinite(m2) and (is_nan or m2 < m):
                rec[:4] = [st2, x2, yA2, yB2]
                pri_host[ci] = pri2
            elif is_nan:
                # both attempts NaN: keep the clean cold state so the
                # next iteration starts from finite values
                rec[:4] = [st_r, st_r.x, st_r.yA, st_r.yB]
                pri_host[ci] = np.inf
            if not (m2 <= thr):
                no_retry.add(ci)
        # pass 2b — the scenario hospital. Not for split data: its
        # per-scenario (cap, m, n) batched factors are what the df32
        # representation exists to avoid; df32 relies on chunk retries
        # and blacklist re-admission
        if bool(self.options.get("subproblem_hospital", True)) \
                and not isinstance(data.A, (SplitMatrix, ScaledView)):
            gate_syncs += self._hospitalize(key, slices, solved_chunks,
                                            data, thr, bool(w_on), bool(prox_on),
                                            kw, pri_host=pri_host)
        # standing casualties: rows still above the gate enter x̄/W with
        # their loose solutions this iteration; say so when anything
        # listens
        if self._trace_consumers_active():
            standing = []
            for ci, (idx_c, real) in enumerate(slices):
                pr = pri_host[ci][:real]
                bad = np.flatnonzero(~(pr <= thr))
                if bad.size:
                    ids = idx_c.tolist()
                    standing += [(ids[r], float(pr[r])) for r in bad
                                 if ids[r] < self._S_orig]
            if standing:
                g_w, pr_w = max(standing, key=lambda t: t[1])
                when = (f"re-admission in {readmit - calls % readmit} "
                        "solves" if readmit else "re-admission disabled")
                obs.counter_add("ph.standing_rows", len(standing))
                self._trace_note(
                    "ph.standing",
                    f"standing: {len(standing)} scenario row(s) above "
                    f"pri_rel gate {thr:.0e} enter xbar/W loose "
                    f"(worst s{g_w}:{pr_w:.0e}; {when})",
                    rows=len(standing), gate=thr, worst_scenario=g_w,
                    worst_pri_rel=pr_w)
        ent["gate_syncs"] += gate_syncs
        obs.counter_add("ph.gate_syncs", gate_syncs)
        _lap("gate")
        # pass 3 — per-chunk objectives on the accepted solutions, pad
        # rows trimmed (a dispatch pass keeps them: its scatter writes
        # the padded width, duplicate ids carrying equal rows)
        parts = {k: [] for k in ("x", "yA", "yB", "xn", "base", "solved",
                                 "dual")}
        for ci, (idx_c, real) in enumerate(slices):
            st, x, yA, yB, d_h, q_h, _ = solved_chunks[ci]
            states[ci] = st
            xn, base, solved, dual = _ph_chunk_objs(
                x, yA, yB, d_h, q_h, self.c[idx_c], self.c0[idx_c],
                self.P_diag[idx_c], self.nonant_idx, self.W[idx_c],
                w_on=bool(w_on))
            keep = x.shape[0] if dispatch is not None else real
            for k, v in (("x", x), ("yA", yA), ("yB", yB), ("xn", xn),
                         ("base", base), ("solved", solved),
                         ("dual", dual)):
                parts[k].append(v[:keep])
        if split_mode and prev_st is not None:
            # UNIFY after the pass: every chunk state adopts the flow's
            # final (rho_scale, factor), so ONE factor persists between
            # passes (at most two are alive during one: the inherited one
            # and, briefly, a refactorized successor)
            for ci in range(len(states)):
                states[ci] = states[ci]._replace(
                    L=prev_st.L, rho_scale=prev_st.rho_scale)
        cat = {k: torch.cat(v) for k, v in parts.items()}
        if dispatch is not None:
            # scatter-back: the dispatched rows' results land in the
            # full-width arrays; every other row (solution, duals, warm
            # state, objectives) carries forward untouched. Store rows
            # take the SCALED post-solve states, x/yA/yB the unscaled
            # solutions
            from ..ops.dispatch import scatter_rows
            ids = torch.as_tensor(ids_pad, device=self.device)
            last = states[-1]
            store = dstore._replace(
                L=last.L, rho_scale=last.rho_scale, iters=last.iters,
                **{f: scatter_rows(getattr(dstore, f), ids,
                                   torch.cat([getattr(s, f)
                                              for s in states]))
                   for f in _ChunkStateView._FIELDS})
            self._dispatch_stores[key] = store
            # the store doubles as this mode's QPState for the read-only
            # consumers (residual summaries, warm-start transplants)
            self._qp_states[key] = store
            self.x = scatter_rows(self.x, ids, cat["x"])
            self.yA = scatter_rows(self.yA, ids, cat["yA"])
            self.yB = scatter_rows(self.yB, ids, cat["yB"])
            self._last_base_obj = scatter_rows(self._last_base_obj, ids,
                                               cat["base"])
            self._last_solved_obj = scatter_rows(self._last_solved_obj,
                                                 ids, cat["solved"])
            self._last_dual_obj = scatter_rows(self._last_dual_obj, ids,
                                               cat["dual"])
            _lap("reduce")
            self._ext("post_solve")
            return self._last_solved_obj
        self._qp_states[key] = _ChunkStateView(
            states, [real for _, real in slices])
        self.x, self.yA, self.yB = cat["x"], cat["yA"], cat["yB"]
        if update:
            wmask = None if self._w_scale is None else self._w_scale > 0
            xbar_new, xsqbar_new, W_new, conv = _ph_combine(
                cat["xn"], self.prob, self.xbar_weights,
                tuple(self.memberships), self.W, self.rho, wmask,
                slot_slices=self.slot_bounds)
            self.xbar, self.xsqbar = xbar_new, xsqbar_new
            self.W_new = W_new
            # the per-iteration convergence scalar: the one designed sync
            self.conv = float(conv)
            obs.gauge_set("ph.conv", self.conv)
        self._last_base_obj = cat["base"]
        self._last_solved_obj = cat["solved"]
        self._last_dual_obj = cat["dual"]
        _lap("reduce")
        self._ext("post_solve")
        return cat["solved"]

    def _hospitalize(self, key, slices, solved_chunks, data, thr, w_on,
                     prox_on, kw, pri_host=None):
        """Per-scenario rescue solves for chunked-mode stragglers. The
        shared factor's scaling and rho patterns are computed against
        the reference cost c while PH solves q = c + (W − ρx̄); for an
        outlier scenario that compromise can stall ADMM far from
        feasibility. Selected scenarios (worst first, at most
        ``subproblem_hospital_max``, the selection padded to that cap)
        are re-assembled and solved NON-shared from cold: own scaling
        against their own q, own adaptive rho, own (n, n) factor. Their
        unscaled solution and residual rows replace the chunk records'
        rows (as new tensors); the chunk states keep their own iterates,
        which live in another scaling. A scenario the hospital does not
        cure is not treated again until re-admission.

        ``pri_host``: the gate's (n_chunks, chunk) host residual matrix;
        cured rows are written back into it. Returns the number of
        host transfers made (0 or 1)."""
        cap = int(self.options.get("subproblem_hospital_max", 4))
        failed = self._hospital_no_retry.setdefault(key, set())
        picks = []                      # (chunk, row, scenario, pri_rel)
        for ci, (idx_c, real) in enumerate(slices):
            pr = (solved_chunks[ci][0].pri_rel.cpu().numpy()
                  if pri_host is None else pri_host[ci])[:real]
            bad = np.flatnonzero(~(pr <= thr))
            if not bad.size:
                continue
            ids = idx_c.tolist()
            for r in bad:
                # keyed by GLOBAL scenario id: chunk-local coordinates
                # would re-target other scenarios if the chunk changed
                g = ids[r]
                if g not in failed and g < self._S_orig:
                    picks.append((ci, int(r), g, float(pr[r])))
        if not picks:
            return 0
        picks.sort(key=lambda t: -t[3])     # worst first under the cap
        picks = picks[:cap]
        sel = np.array([g for _, _, g, _ in picks])
        pad = cap - sel.size
        sel_p = np.concatenate([sel, np.full(pad, sel[0])]) if pad else sel
        k = sel_p.size
        sel_t = torch.as_tensor(sel_p, dtype=torch.long, device=self.device)
        n = int(data.lb.shape[-1])
        A_b = data.A.expand(k, *data.A.shape) if data.A.ndim == 2 \
            else data.A[sel_t]
        P_b = data.P_diag.expand(k, n) if data.P_diag.ndim == 1 \
            else data.P_diag[sel_t]
        d_h = QPData(P_b, A_b, data.l[sel_t], data.u[sel_t],
                     data.lb[sel_t], data.ub[sel_t])
        ws = None if self._w_scale is None else self._w_scale[sel_t]
        q_h, bl_h, bu_h = _ph_assemble(
            d_h, self.c[sel_t], self.W[sel_t], self.xbar[sel_t],
            self.rho[sel_t], self.nonant_idx, self._fixed_mask[sel_t],
            self._fixed_vals[sel_t], ws, w_on=w_on, prox_on=prox_on)
        d_h = d_h._replace(lb=bl_h, ub=bu_h)
        fac_h = qp_setup(d_h, q_ref=q_h)
        st_h = qp_cold_state(fac_h, d_h)
        # native precision, a larger budget and long segments: the
        # batch is a few rows
        st_h, x_h, yA_h, yB_h = _solver_call(
            fac_h, d_h, q_h, st_h,
            **dict(kw, precision="native", kernel=None,
                   sub_max_iter=max(6000, kw["sub_max_iter"]),
                   segment=1500))
        pr_h = st_h.pri_rel.cpu().numpy()
        obs.counter_add("ph.hospital_treated", len(picks))
        worst = " ".join(
            f"s{g}:{pr_old:.0e}->{pr_h[j]:.0e}"
            for j, (_, _, g, pr_old) in enumerate(picks))
        self._trace_note(
            "ph.hospital",
            f"hospital: treated {len(picks)} scenario(s) [{worst}]",
            treated=len(picks),
            scenarios=[{"scenario": g, "pri_rel_before": pr_old,
                        "pri_rel_after": float(pr_h[j])}
                       for j, (_, _, g, pr_old) in enumerate(picks)])
        for j, (ci, r, g, pr_old) in enumerate(picks):
            if not (pr_h[j] <= thr):
                # one shot per scenario until re-admission; an improved
                # row still gets its better solution below
                failed.add(g)
            if not (pr_h[j] < pr_old):
                continue
            rec = solved_chunks[ci]
            st = rec[0]
            rec[0] = st._replace(
                pri_res=_set_row(st.pri_res, r, st_h.pri_res[j]),
                dua_res=_set_row(st.dua_res, r, st_h.dua_res[j]),
                pri_rel=_set_row(st.pri_rel, r, st_h.pri_rel[j]),
                dua_rel=_set_row(st.dua_rel, r, st_h.dua_rel[j]))
            rec[1] = _set_row(rec[1], r, x_h[j])
            rec[2] = _set_row(rec[2], r, yA_h[j])
            rec[3] = _set_row(rec[3], r, yB_h[j])
            if pri_host is not None:
                pri_host[ci][r] = pr_h[j]
        return 1

    # ------------- phase anatomy -------------
    def reset_phase_timing(self):
        """Zero the per-phase wall-clock accumulators. Telemetry
        counters (ph.gate_syncs and friends) are cumulative and survive
        this reset."""
        self._phase_times.clear()

    def phase_timing(self, key=True):
        """Per-phase wall-clock anatomy of the solve loop for one mode
        key: mean seconds per solve_loop call in each phase (assemble /
        solve / gate / reduce; the unchunked path books gate 0), the
        occupancy estimate solve / total (the solve phase is the one
        that waits on the device), the gate's host syncs per call, and
        the kernel plan's descriptor. None when the key never ran."""
        ent = self._phase_times.get(key)
        if not ent or not ent["calls"]:
            return None
        n = ent["calls"]
        per_call = {p: ent["acc"][p] / n for p in
                    ("assemble", "solve", "gate", "reduce")}
        total = sum(per_call.values())
        return {
            "calls": n,
            "seconds_per_call": per_call,
            "occupancy": (per_call["solve"] / total) if total > 0 else 0.0,
            "gate_d2h_syncs_per_call": ent["gate_syncs"] / n,
            "devices": ent["devices"],
            "mode": ent.get("mode", "host"),
            "kernel": ent.get("kernel"),
        }

    def _phase_totals(self):
        """Accumulated per-phase wall-clock summed over every mode."""
        tot = {"assemble": 0.0, "solve": 0.0, "gate": 0.0, "reduce": 0.0}
        for ent in self._phase_times.values():
            for k, v in ent["acc"].items():
                tot[k] += v
        return tot

    def residual_summary(self, key=True):
        """Host summary of the last solve's relative residuals for one
        mode key (None when that mode never ran); reads an (S,) vector
        back from the device."""
        st = self._qp_states.get(key)
        if st is None:
            return None
        pri = st.pri_rel.cpu().numpy()[:self._S_orig]
        dua = st.dua_rel.cpu().numpy()[:self._S_orig]
        return {"pri_rel_max": float(pri.max()),
                "pri_rel_mean": float(pri.mean()),
                "dua_rel_max": float(dua.max()),
                "dua_rel_mean": float(dua.mean())}

    def iter0_feasible_mask(self, tol=None):
        """(ok_per_scenario, tol): a scenario passes on EITHER the
        absolute or the relative primal residual of its iter-0 solve."""
        if tol is None:
            tol = float(self.options.get("iter0_feas_tol",
                                         max(1e-3, 100 * self.sub_eps)))
        st = self._qp_states[False]
        ok = (st.pri_res.cpu().numpy()[:self._S_orig] <= tol) \
            | (st.pri_rel.cpu().numpy()[:self._S_orig] <= tol)
        return ok, tol

    def assert_feasible_iter0(self, tol=None):
        """Abort when any scenario's iter-0 subproblem came out
        infeasible (ref. phbase.py:1415-1427); gated by the
        ``iter0_infeasibility_abort`` option (default on)."""
        if not self.options.get("iter0_infeasibility_abort", True):
            return
        ok, tol = self.iter0_feasible_mask(tol)
        if not np.all(ok):
            bad = np.flatnonzero(~ok)
            names = [self.batch.tree.scen_names[i] for i in bad[:5]]
            raise RuntimeError(
                f"iter0: {bad.size} scenario subproblem(s) infeasible "
                f"(pri_rel > {tol:g}), e.g. {names} — aborting like the "
                "reference's iter-0 infeasibility quit "
                "(ref. phbase.py:1415-1427)")

    # ------------- reference-named primitives -------------
    def Compute_Xbar(self):
        xn = self.nonants_of(self.x)
        self.xbar = self.compute_xbar(xn)
        self.xsqbar = self.compute_xbar(xn * xn)

    def Update_W(self):
        xn = self.nonants_of(self.x)
        W = self.W + self.rho * (xn - self.xbar)
        if self._w_scale is not None:
            W = torch.where(self._w_scale > 0, W, 0.0)
        self.W = W

    def Ebound(self):
        """Expected certified subproblem lower bound (ref. phbase.py:314),
        from the ADMM dual vectors, not the primal objectives."""
        return float(self.Eobjective(self._last_dual_obj))

    def update_best_bound(self, bound):
        """Monotone best-outer-bound bookkeeping; True when it moved."""
        if bound is None:
            return False
        b = float(bound)
        if np.isfinite(b) and b > self.best_bound:
            self.best_bound = b
            return True
        return False

    def Eobjective_value(self):
        return float(self.Eobjective(self._last_base_obj))

    # ------------- fixing (ref. phbase.py:413, xhat_tryer.py:126) -------
    def fix_nonants(self, values, mask=None):
        """Pin nonant slots to ``values`` ((S, K) or (K,)); ``mask``
        ((S, K) or (K,) bool) selects the slots, default all."""
        S, K = self.batch.S, self.batch.K

        def dev(a, dtype):
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a))
            return a.to(device=self.device, dtype=dtype).expand(S, K)

        self._fixed_vals = dev(values, self.dtype)
        self._fixed_mask = (torch.ones((S, K), dtype=torch.bool,
                                       device=self.device)
                            if mask is None else dev(mask, torch.bool))

    def unfix_nonants(self):
        self._fixed_mask = torch.zeros((self.batch.S, self.batch.K),
                                       dtype=torch.bool, device=self.device)

    # ------------- incumbent evaluation (ref. xhat_tryer.py:126-182) ----
    @property
    def nonant_integer_mask(self):
        """(K,) bool: which nonant slots are integer variables."""
        return np.asarray(self.batch.integer)[np.asarray(
            self.batch.nonant_idx)]

    def round_nonants(self, vals):
        """Round integer nonant slots to the nearest integer (the
        incumbent heuristics' stand-in for MIP feasibility of
        first-stage vars). Host numpy in and out."""
        vals = to_host(vals, np.float64)
        return np.where(self.nonant_integer_mask, np.round(vals), vals)

    def calculate_incumbent(self, xhat_vals, feas_tol=None, pin_mask=None):
        """Fix nonants at ``xhat_vals`` ((K,) or (S, K)), solve with
        W/prox off, and return the expected objective, or None if any
        scenario's subproblem is infeasible at that x̂ (ref.
        xhat_tryer.py:159-182, xhatbase.py:129-134). Feasibility = the
        primal residual below ``feas_tol``, absolute or relative.

        ``pin_mask`` ((K,) bool, default all): pin only those nonant
        slots. Models whose nonant blocks hold DERIVED variables (UC's
        startup indicators, determined by the commitments) leave those
        to the solve. The engine's solutions, objectives and fixings
        are restored afterwards: this can run while a hub or another
        spoke reads them."""
        if feas_tol is None:
            feas_tol = float(self.options.get("xhat_feas_tol", 1e-4))
        saved = (self._fixed_mask, self._fixed_vals, self.x,
                 getattr(self, "yA", None), getattr(self, "yB", None),
                 getattr(self, "_last_base_obj", None),
                 getattr(self, "_last_solved_obj", None),
                 getattr(self, "_last_dual_obj", None))
        self.fix_nonants(self.round_nonants(xhat_vals), mask=pin_mask)
        try:
            # integer columns OUTSIDE the nonant set (second-stage
            # integers) need a dive to integral values (ref.
            # xhatbase.py:117 solves fixed-nonant MIPs)
            n = self.batch.n
            nonant_cols = np.zeros(n, bool)
            nonant_cols[np.asarray(self.batch.nonant_idx)] = True
            rec_ints = np.asarray(self.batch.integer) & ~nonant_cols
            if rec_ints.any() and self.options.get("xhat_dive_integers",
                                                   True):
                factors, d0 = self._get_factors(False, fixed=True)
                idx = self.nonant_idx
                d = d0._replace(
                    lb=d0.lb.index_copy(1, idx, torch.where(
                        self._fixed_mask, self._fixed_vals, d0.lb[:, idx])),
                    ub=d0.ub.index_copy(1, idx, torch.where(
                        self._fixed_mask, self._fixed_vals, d0.ub[:, idx])))
                st = self._ensure_state(False, fixed=True)
                x, obj, feasible, _ = self._dive_in_chunks(
                    factors, d, self.c, self.c0, st, rec_ints,
                    max_iter=self.sub_max_iter, eps=self.sub_eps,
                    feas_tol=feas_tol, polish_chunk=self.sub_polish_chunk)
                if not bool(feasible.all()):
                    return None
                return float(self.Eobjective(obj))
            self.solve_loop(w_on=False, prox_on=False, update=False,
                            fixed=True)
            st = self._qp_states[("fixed", False)]
            pri = to_host(st.pri_res)
            rel = to_host(st.pri_rel)
            if not np.all((pri <= feas_tol) | (rel <= feas_tol)):
                # an infeasible candidate leaves a DIVERGED state behind
                # (blown rho_scale, huge duals): warm-starting the NEXT
                # candidate from it can "converge" by the corrupt
                # scale's relative criteria to a wrong objective. Drop
                # it, the chunked mode's per-chunk states too, so the
                # next evaluation restarts clean
                self._qp_states.pop(("fixed", False), None)
                self._chunk_states.pop(("fixed", False), None)
                return None
            return self.Eobjective_value()
        finally:
            (self._fixed_mask, self._fixed_vals, self.x, self.yA, self.yB,
             self._last_base_obj, self._last_solved_obj,
             self._last_dual_obj) = saved

    def _dive_in_chunks(self, factors, d, q, c0, st, imask, **kw):
        """core.mip.dive_integers with scenario microbatching. Dives
        have no cross-scenario coupling (each scenario pins its own
        columns), so chunking is exact."""
        from .mip import dive_integers

        chunk = int(self.options.get("subproblem_chunk", 0) or 0)
        S = self.batch.S
        if not (chunk and chunk < S):
            return dive_integers(factors, d, q, c0, st, imask, **kw)
        if factors.A_s.ndim != 2:
            raise ValueError("subproblem_chunk requires a shared-"
                             "structure batch (see _solve_loop_chunked)")
        n = d.lb.shape[-1]
        imask_b = torch.as_tensor(np.asarray(imask), dtype=torch.bool,
                                  device=self.device).expand(S, n)
        q_b = q.expand(S, n)
        c0_b = c0.expand(S)
        xs, objs, feas = [], [], []
        for idx_c, real in self._chunk_index(chunk):
            d_c = d._replace(l=d.l[idx_c], u=d.u[idx_c],
                             lb=d.lb[idx_c], ub=d.ub[idx_c])
            st_c = st._replace(
                x=st.x[idx_c], yA=st.yA[idx_c], yB=st.yB[idx_c],
                zA=st.zA[idx_c], zB=st.zB[idx_c],
                pri_res=st.pri_res[idx_c], dua_res=st.dua_res[idx_c],
                pri_rel=st.pri_rel[idx_c], dua_rel=st.dua_rel[idx_c])
            x, o, f, _ = dive_integers(factors, d_c, q_b[idx_c],
                                       c0_b[idx_c], st_c, imask_b[idx_c],
                                       **kw)
            xs.append(x[:real])
            objs.append(o[:real])
            feas.append(f[:real])
        return torch.cat(xs), torch.cat(objs), torch.cat(feas), st

    def dive_nonant_candidates(self, X=None, feas_tol=None, max_iter=None,
                               dive_slots=None):
        """Per-scenario INTEGER-FEASIBLE nonant schedules via the batched
        dive: incumbent candidates for the x̂ spokes on integer models.
        Every scenario's subproblem dives to integer feasibility on the
        NONANT integer mask, prox-regularized toward ``X`` (the hub's
        consensus) when given (ref. xhatshufflelooper_bounder.py:108
        uses solved MIP scenario values; this is the batched analog).

        ``dive_slots`` ((K,) bool, default all): restrict the dive to
        those nonant slots' integer columns — the candidate side of
        calculate_incumbent's ``pin_mask``.

        Returns host (cands (S, K), feasible (S,) bool)."""
        if feas_tol is None:
            # the df32 residual floor under heavily pinned bounds sits
            # near 1e-3; consumers that need certainty re-evaluate the
            # winners exactly (xhat_exact_eval / host oracle)
            feas_tol = 5e-3 if self.sub_precision == "df32" else 1e-3
        n = self.batch.n
        idx_np = np.asarray(self.batch.nonant_idx)
        imask = np.zeros(n, bool)
        imask[idx_np] = np.asarray(self.batch.integer)[idx_np]
        if dive_slots is not None:
            keep = np.zeros(n, bool)
            keep[idx_np[np.asarray(dive_slots, bool)]] = True
            imask &= keep
        if not imask.any():
            xn = self._hub_nonants() if X is None else X
            return to_host(xn), np.ones(self.batch.S, bool)
        prox_on = X is not None
        factors, d = self._get_factors(prox_on, full=True)
        if prox_on:
            Xt = torch.as_tensor(np.array(X, dtype=np.float64),
                                 dtype=self.dtype, device=self.device)
            q = self.c.index_add(1, self.nonant_idx, -self.rho * Xt)
        else:
            q = self.c
        st = self._ensure_state(prox_on)
        kw = {}
        pf = self.options.get("xhat_dive_pin_frac")
        if pf is not None:
            kw["pin_frac"] = int(pf)
        mr = self.options.get("xhat_dive_rounds")
        if mr is not None:
            kw["max_rounds"] = int(mr)
        x, _, feasible, _ = self._dive_in_chunks(
            factors, d, q, self.c0, st, imask,
            max_iter=int(max_iter or min(self.sub_max_iter, 1500)),
            eps=max(self.sub_eps, 1e-6), feas_tol=feas_tol,
            polish_chunk=self.sub_polish_chunk, **kw)
        return to_host(x)[:, idx_np], to_host(feasible)

    def _hub_nonants(self):
        """(S, K) latest subproblem nonant values for cylinder traffic
        (ref. phbase.py:562-617 nonant flat caches)."""
        return self.nonants_of(self.x)

    # ------------- batched incumbent-pool evaluation -------------
    def _pool_chunk_index(self, P, chunk):
        """(scenario_idx, candidate_idx, real) per pool chunk: pool
        solves linearize the (candidate, scenario) grid as rows
        r = p*S + s and microbatch them like the PH hot loop (the tail
        chunk pads by repeating its last row, so every call has one
        shape). Cached beside the PH chunk index."""
        S = self.batch.S
        rows = P * S
        key = ("pool", P, chunk, S)
        if key not in self._chunk_idx_cache:
            out = []
            for i in range(0, rows, chunk):
                r = np.arange(i, min(i + chunk, rows))
                real = r.size
                if real < chunk:
                    r = np.concatenate([r, np.full(chunk - real, r[-1])])
                out.append((torch.as_tensor(r % S, device=self.device),
                            torch.as_tensor(r // S, device=self.device),
                            real))
            self._chunk_idx_cache[key] = out
        return self._chunk_idx_cache[key]

    def evaluate_incumbent_pool(self, pool, pin_mask=None, feas_tol=None):
        """Batched fix-and-dive evaluation of a (P, K) candidate pool
        (ops/incumbent): every candidate's pinned nonant slots are
        fixed (l = u = x̂) across ALL scenarios, the continuous recourse
        re-solves through the engine's solve path (the pool rows are
        more chunks of it, ``subproblem_kernel_mode`` honored), and the
        feasibility screen and Eobjective land in ONE stacked
        device-to-host verdict per call. Returns host ``(objs (P,),
        feasible (P,) bool)`` with infeasible candidates' objectives at
        +inf. Equivalent to P ``calculate_incumbent`` calls; shapes the
        chunked solver cannot batch (per-scenario A) or that need the
        recourse-integer dive run those calls instead."""
        if feas_tol is None:
            feas_tol = float(self.options.get("xhat_feas_tol", 1e-4))
        if not isinstance(pool, torch.Tensor):
            pool = torch.as_tensor(np.asarray(pool))
        pool = pool.to(device=self.device, dtype=self.dtype)
        P, S = int(pool.shape[0]), self.batch.S
        n = self.batch.n
        idx_np = np.asarray(self.batch.nonant_idx)
        nonant_cols = np.zeros(n, bool)
        nonant_cols[idx_np] = True
        rec_ints = np.asarray(self.batch.integer, bool) & ~nonant_cols
        factors, d0 = self._get_factors(False, fixed=True)
        if (rec_ints.any() and self.options.get("xhat_dive_integers",
                                                True)) \
                or factors.A_s.ndim != 2:
            objs = np.full(P, np.inf)
            feas = np.zeros(P, bool)
            for p in range(P):
                v = self.calculate_incumbent(pool[p], feas_tol=feas_tol,
                                             pin_mask=pin_mask)
                if v is not None:
                    objs[p] = v
                    feas[p] = True
            obs.counter_add("incumbent.gate_syncs", P)
            return objs, feas
        from ..ops.incumbent import pool_verdict
        K = self.batch.K
        pin = np.ones(K, bool) if pin_mask is None \
            else np.asarray(pin_mask, bool)
        imask = torch.as_tensor(self.nonant_integer_mask,
                                device=self.device)
        vals = torch.where(imask, torch.round(pool), pool)
        pmb = torch.as_tensor(pin, device=self.device)
        rows = P * S
        copt = int(self.options.get("subproblem_chunk", 0) or 0)
        chunk = copt if (copt and copt < rows) else rows
        slices = self._pool_chunk_index(P, chunk)
        plan = self._kernel_plan(("pool", chunk), factors, chunk)
        kw = dict(prox_on=False, precision=self.sub_precision,
                  sub_max_iter=self.sub_max_iter, sub_eps=self.sub_eps,
                  sub_eps_hot=self.sub_eps_hot,
                  sub_eps_dua_hot=self.sub_eps_dua_hot,
                  tail_iter=self.sub_tail_iter,
                  stall_rel=self.sub_stall_rel, segment=self.sub_segment,
                  polish_hot=self.sub_polish_hot,
                  polish_chunk=self.sub_polish_chunk,
                  segment_lo=self.sub_segment_lo,
                  ir_sweeps=self.sub_ir_sweeps, kernel=plan,
                  # FIXED stepsize: shared-mode rho adaptation is a
                  # geometric mean over the batch rows, and a pool
                  # always holds infeasible members whose diverging
                  # ratios would contaminate the shared scalar
                  adaptive_rho=False)
        ck = (P, chunk)
        states = self._pool_states.get(ck)
        if states is None:
            # ONE cold state serves every chunk (identical shapes, and
            # nothing writes a state in place)
            sidx0, pidx0, _ = slices[0]
            lb0, ub0, l0, u0, _, _ = _pool_assemble(
                d0.lb, d0.ub, d0.l, d0.u, self.c, self.c0, vals, pmb,
                self.nonant_idx, sidx0, pidx0)
            st0 = qp_cold_state(factors, d0._replace(lb=lb0, ub=ub0,
                                                     l=l0, u=u0))
            states = self._pool_states[ck] = [st0] * len(slices)
        split_mode = isinstance(factors.A_s, SplitMatrix)
        prev_st = None
        outs = []
        for ci, (sidx, pidx, _) in enumerate(slices):
            lb_c, ub_c, l_c, u_c, q_c, c0_c = _pool_assemble(
                d0.lb, d0.ub, d0.l, d0.u, self.c, self.c0, vals, pmb,
                self.nonant_idx, sidx, pidx)
            d_c = d0._replace(lb=lb_c, ub=ub_c, l=l_c, u=u_c)
            st_in = states[ci]
            if split_mode and prev_st is not None:
                # df32 chunks FLOW one (rho_scale, factor) pair, as the
                # chunked hot loop does
                st_in = st_in._replace(L=prev_st.L,
                                       rho_scale=prev_st.rho_scale)
            st, x, _, _ = _solver_call(factors, d_c, q_c, st_in, **kw)
            prev_st = st
            if split_mode:
                st = st._replace(L=None)
            states[ci] = st
            outs.append((qp_objective(d_c, q_c, c0_c, x),
                         st.pri_res, st.pri_rel))
        if split_mode and prev_st is not None:
            for ci in range(len(states)):
                states[ci] = states[ci]._replace(
                    L=prev_st.L, rho_scale=prev_st.rho_scale)
        obj_rows = torch.cat([o for o, _, _ in outs])[:rows]
        pri_res = torch.cat([r for _, r, _ in outs])[:rows]
        pri_rel = torch.cat([r for _, _, r in outs])[:rows]
        live = torch.as_tensor(np.arange(S) < self._S_orig,
                               device=self.device)
        v = to_host(pool_verdict(obj_rows, pri_res, pri_rel, self.prob,
                                    live, feas_tol, P=P, S=S))
        # THE one stacked device-to-host read of the round
        obs.counter_add("incumbent.gate_syncs")
        if obs.enabled():
            obs.counter_add("xfer.d2h_bytes", v.nbytes)
            if plan.mode == "fused":
                obs.counter_add("kernel.fused_iters",
                                sum(int(s.iters) for s in states))
        feas = v[1] > 0.5
        if not feas.all():
            # cold-reset the infeasible candidates' rows before the
            # states warm-start the next round; tail-chunk pad rows
            # duplicate the LAST candidate's rows and inherit its verdict
            keep = np.repeat(feas, S)
            keep = np.concatenate(
                [keep, np.full(len(slices) * chunk - rows, feas[-1])])
            for ci in range(len(states)):
                kc = torch.as_tensor(keep[ci * chunk:(ci + 1) * chunk],
                                     device=self.device)
                states[ci] = _pool_rows_zeroed(states[ci], kc)
        objs = np.where(feas, v[0], np.inf)
        return objs, feas

    # ------------- extension hooks (ref. extensions/extension.py:14) ----
    def _ext(self, hook):
        if self.extensions is not None:
            getattr(self.extensions, hook)(self)


class PH(PHBase):
    """Synchronous PH driver (ref. mpisppy/opt/ph.py:26 ph_main)."""

    def ph_main(self, finalize=True):
        self._ext("pre_iter0")
        # Iter 0: no W, no prox (ref. phbase.py:1364 Iter0); a warm
        # start keeps the loaded W (and an xbar-only warm start keeps
        # the loaded prox center)
        warm = getattr(self, "_warm_started", False)
        warm_xbar = getattr(self, "_warm_started_xbar", False)
        self.solve_loop(w_on=warm, prox_on=False, update=not warm_xbar)
        self.assert_feasible_iter0()
        if not warm:
            self.Update_W()  # W was zero, so W = rho(x - xbar)
        self.trivial_bound = self.Ebound()  # certified wait-and-see bound
        self.update_best_bound(self.trivial_bound)
        self._iter = 0
        obs.event("ph.iter0", {"trivial_bound": self.trivial_bound})
        self._ext("post_iter0")
        if self.converger_cls is not None:
            self.converger = self.converger_cls(self)
        global_toc(f"PH iter 0: trivial bound = {self.trivial_bound:.4f}",
                   self.verbose)
        if self.spcomm is not None:
            # iter-0 sync: push the first W / nonants and collect any
            # bounds the spokes produced while the device ran iter 0
            # (the reference's hub first syncs inside iterk_loop, ref.
            # phbase.py:1522)
            self.spcomm.sync()
            self.update_best_bound(
                getattr(self.spcomm, "BestOuterBound", None))
            if self.spcomm.is_converged():
                global_toc("PH iter 0: hub termination", self.verbose)
                if finalize:
                    return self.post_loops()
                return self.conv

        # Iter k loop (ref. phbase.py:1472 iterk_loop)
        for it in range(1, self.max_iterations + 1):
            self._iter = it
            t_it = _time.perf_counter()
            self.solve_loop(w_on=True, prox_on=True)
            self.W = self.W_new
            if obs.enabled():
                t_end = _time.perf_counter()
                obs.complete_span("ph.iteration", t_it, t_end, cat="ph",
                                  args={"iter": it})
                obs.histogram_observe("ph.iteration_seconds", t_end - t_it)
                obs.event("ph.iteration", {"iter": it, "conv": self.conv,
                                           "seconds": t_end - t_it})
            self._ext("miditer")
            if self.spcomm is not None:
                self.spcomm.sync()
                # spoke bounds (device-dual or exact-oracle) flow back
                # to the engine's best-bound bookkeeping
                self.update_best_bound(
                    getattr(self.spcomm, "BestOuterBound", None))
                if self.spcomm.is_converged():
                    global_toc(f"PH iter {it}: hub termination",
                               self.verbose)
                    break
            if self.converger is not None and self.converger.is_converged():
                global_toc(f"PH iter {it}: converger termination",
                           self.verbose)
                break
            if self.conv is not None and self.conv < self.convthresh:
                global_toc(f"PH iter {it}: conv={self.conv:.3e} < thresh",
                           self.verbose)
                break
            self._ext("enditer")
            if self.verbose and (it % 10 == 0 or it == 1):
                global_toc(f"PH iter {it}: conv={self.conv:.6e} "
                           f"Eobj={self.Eobjective_value():.4f}")
        if finalize:
            return self.post_loops()
        return self.conv

    def post_loops(self):
        """ref. phbase.py:1568: final Eobjective and extension wrap-up."""
        self._ext("post_everything")
        return self.conv, self.Eobjective_value(), self.trivial_bound
