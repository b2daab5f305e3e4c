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
from types import SimpleNamespace

import numpy as np
import torch

from .. import global_toc, obs
from ..obs import resource as _obs_resource
from ..ir.batch import ScenarioBatch
from ..ops.qp_solver import (QPData, ScaledView, SplitMatrix,
                             mesh_scope, qp_cold_state, qp_dual_objective,
                             qp_objective, qp_reset_rho, qp_setup,
                             qp_setup_like, qp_solve_mixed,
                             qp_solve_segmented, stacked_residuals)
from ..parallel.mesh import scenario_combine
from ..utils.runtime import to_host
from .spbase import SPBase, batch_cache

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


def _not_ported(what, item=None):
    where = "ROADMAP.md" if item is None else f"ROADMAP.md {item}"
    return NotImplementedError(f"{what} is not ported yet (see {where})")


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
                slot_slices, shard_ops=None):
    """Compute_Xbar + Update_W + convergence over the nonant block
    (parallel/mesh.scenario_combine); on a sharded mesh ``shard_ops``
    supplies the mesh, whose ranks sum the node tables and the
    convergence (one all-reduce each)."""
    mesh = None
    if shard_ops is not None:
        shard_ops.book_collective(xn.dtype, full=True)
        mesh = shard_ops.mesh
    return scenario_combine(memberships, slot_slices, xn, prob, xbar_w, W,
                            rho, wmask, mesh)


def _ph_reduce(x, yA, yB, d, q, c, c0, P0, prob, xbar_w, memberships, idx,
               W, rho, wmask, *, w_on, slot_slices, shard_ops=None):
    """Stage 3: the composition of _ph_chunk_objs and _ph_combine."""
    xn, base_obj, solved_obj, dual_obj = _ph_chunk_objs(
        x, yA, yB, d, q, c, c0, P0, idx, W, w_on=w_on)
    xbar_new, xsqbar_new, W_new, conv = _ph_combine(
        xn, prob, xbar_w, memberships, W, rho, wmask,
        slot_slices=slot_slices, shard_ops=shard_ops)
    return xn, xbar_new, xsqbar_new, W_new, conv, base_obj, solved_obj, \
        dual_obj


def _shrink_objs(x_full, c, c0, P0, W, idx, *, w_on):
    """Objectives of an EXPANDED compacted solve, evaluated on the
    full-width solution against the FULL cost structures, so they are
    comparable with the uncompacted path's (the fixed columns enter
    through their folded values). The dual bound stays on the compacted
    system (_shrink_dual)."""
    xn = x_full[:, idx]
    base = torch.sum(c * x_full, dim=1) + c0 \
        + 0.5 * torch.sum(P0 * x_full * x_full, dim=1)
    solved = base + (torch.sum(W * xn, dim=1) if w_on else 0.0)
    return xn, base, solved


def _shrink_dual(d, q, c0_fold, yA, yB, x_c):
    """Certified dual bound of a compacted solve: qp_dual_objective on
    the compacted system plus the fold constant, which is the dual bound
    of the PINNED full problem (lb = ub makes the fixed columns' dual
    contribution that constant)."""
    return qp_dual_objective(d, q, c0_fold, yA, yB, x_witness=x_c)


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
             lap=None, kernel=None, shard_ops=None):
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
                            slot_slices=slot_slices, shard_ops=shard_ops)
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
        super().__init__(batch, options, dtype, device=device, mesh=mesh)
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
        # ---- progressive problem shrinking (ops/shrink) ----
        self._shrink = None            # the active ops/shrink.ShrinkPlan
        self._shrink_factors = {}      # prox_on -> (factors, data_c)
        self._shrink_status = None     # plain host dict for reports
        self._shrink_failed = set()    # targets whose plan came back None
        self._transplant_src = None
        if opts.get("shrink_fix") or opts.get("shrink_compact") \
                or opts.get("shrink_rho"):
            extensions = self._shrink_setup(batch, opts, extensions)
        self._kernel_plans = {}
        # ADMM block launches of plans already dropped (the live plans
        # book their own; kernel_launches sums both)
        self._retired_launches = 0
        # every factor build (_book_factorization): the serving layer's
        # warm-bucket check reads its delta; refactorizations counts
        # the builds of a mode built before
        self.factor_builds = 0
        self.refactorizations = 0
        self._factor_keys_built = set()
        self.rho_setter = rho_setter
        self.extensions = extensions
        self.converger_cls = converger
        self.converger = None

        # this rank's rows on a mesh (self.batch is the shard)
        S, K = self.batch.S, self.batch.K
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
        # wheel forensics (ops/forensics.py): the device-resident
        # attribution carry and the latest unpacked sample (a plain
        # host dict). Sampled every forensics_interval iterations inside
        # iteration_record, so the layer costs nothing with telemetry
        # off.
        self._forensics_every = int(opts.get("forensics_interval", 5))
        self._forensic_state = None
        self._forensic_last = None
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

    def _shrink_setup(self, batch, opts, extensions):
        """Validate the shrink options, start ``_shrink_status`` and,
        when the caller passed no extensions (the CLI), attach the
        device fixer and the per-slot rho updater the options ask for.
        Returns the engine's extensions."""
        if opts.get("shrink_compact"):
            if not opts.get("shrink_fix"):
                raise ValueError("shrink_compact needs shrink_fix (the "
                                 "compaction triggers on the device "
                                 "fixer's fixed-fraction trajectory)")
            if self.sub_precision != "native":
                raise _not_ported(
                    "active-set compaction with subproblem_precision="
                    f"{self.sub_precision!r} (the split-f32 gather)",
                    "A9b")
        from ..utils.config import parse_shrink_buckets
        self._shrink_buckets = parse_shrink_buckets(
            opts.get("shrink_buckets", "0.25,0.5,0.75"))
        self._shrink_status = {
            "fixed": 0, "free": batch.K, "compactions": 0, "bucket": 0.0,
            "n_cols": int(batch.n), "m_rows": int(batch.m),
            "refactorizations": 0, "transplants": 0,
            "transplant_cold": 0,
            "est_hbm_bytes_per_iter": self._shrink_est_hbm(
                int(batch.n), int(batch.m))}
        if extensions is not None:
            return extensions
        from ..extensions.extension import MultiExtension
        from ..extensions.fixer import DeviceFixer
        from ..extensions.norm_rho_updater import DeviceNormRhoUpdater
        exts = []
        if opts.get("shrink_fix"):
            exts.append(DeviceFixer(opts))
        if opts.get("shrink_rho"):
            exts.append(DeviceNormRhoUpdater(opts))
        if not exts:
            return None
        return exts[0] if len(exts) == 1 else MultiExtension(exts)

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
            if self._rho_uniform():
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

    def _rho_uniform(self) -> bool:
        """Whether every scenario carries the same rho row (on a mesh:
        every row of every rank)."""
        same = (self.rho == self.rho[:1]).all()
        if self._shard_ops is None:
            return bool(same)
        r0 = self.rho[0]
        same = same & (self.mesh.all_max(r0) == self.mesh.all_min(r0)).all()
        return self._all_ranks(same)

    def _scope(self):
        """The qp_solver mesh scope of this engine's solves and setups
        (a no-op without a sharded mesh)."""
        return mesh_scope(self.shard_mesh)

    def _get_factors(self, prox_on: bool, fixed: bool = False,
                     full: bool = False):
        """Cached per-mode factorization (invalidated on rho change).

        ``fixed=True`` builds factors for fully-pinned-nonant solves
        (incumbent evaluation): the nonant boxes become equalities
        there, and the ADMM bound-row rho must be eq-boosted for those
        columns or the solve crawls. The boost pattern depends only on
        WHICH columns are pinned, not the values, so one factorization
        serves every candidate x̂.

        While a shrink plan is active the hot-loop modes solve the
        COMPACTED system (``_shrink_get_factors``); fixed-mode solves
        (incumbent evaluation, cut generation) keep the full system.
        ``full=True`` bypasses the plan for consumers that build their
        operands full-width against ``self.c`` (the integer dive).

        Each mode runs its own setup (equilibration + scaled matrix),
        except in df32: there every mode, and every engine over the
        same batch (the batch device cache, core/spbase), shares ONE
        equilibration and scaled split (qp_setup_like over the base
        factors), since another (m, n) split pair per mode or engine
        would cost gigabytes at the scale the representation exists
        for; the engine's raw split A is swapped for a ScaledView over
        the scaled one, so the raw pair frees. The cached tensors are
        never written in place."""
        with self._scope():
            return self._get_factors_impl(prox_on, fixed, full)

    def _get_factors_impl(self, prox_on, fixed, full):
        """The body of _get_factors."""
        if not fixed and not full and self._shrink is not None:
            return self._shrink_get_factors(prox_on)
        key = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        if key not in self._factors:
            self._book_factorization(key)
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

    def _book_factorization(self, key):
        """Count a factor build (``factor_builds``) and, for a mode
        built before (a rho change or a compaction made the old one
        stale), a re-factorization: on the block path each costs a new
        explicit (n, n) inverse. ``key`` None books a compacted build,
        always a re-factorization."""
        self.factor_builds += 1
        if key is not None and key not in self._factor_keys_built:
            self._factor_keys_built.add(key)
            return
        self.refactorizations += 1
        if self._shrink_status is not None:
            self._shrink_status["refactorizations"] += 1

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
        mode's and the compacted system's too), plans and solver states
        (chunked ones included); a new rho also earns every blacklisted
        chunk and scenario a fresh recovery chance."""
        self._retired_launches = self.kernel_launches
        self._kernel_plans.clear()
        for cache in (self._factors, self._qp_states, self._chunk_states,
                      self._dispatch_stores, self._shrink_factors):
            cache.pop(True, None)
            cache.pop(("fixed", True), None)
        self._pool_states.clear()
        self._chunk_no_retry.clear()
        self._hospital_no_retry.clear()
        self._blacklist_calls.clear()
        self._chunk_idx_cache.clear()

    # ------------- active-set compaction (ops/shrink) -------------
    def _shrink_get_factors(self, prox_on: bool):
        """Cached factorization of the COMPACTED system: one
        re-factorization per (bucket transition, mode). Kept apart from
        ``_factors``, which the full-width consumers read while the hot
        loop solves the compacted system. The compacted A, factors and
        data belong to this engine: nothing of them enters the batch
        device cache (core/spbase) that the wheel's other engines read
        at full width."""
        key = bool(prox_on)
        if key not in self._shrink_factors:
            self._book_factorization(None)
            plan = self._shrink
            d = plan.data_c
            if prox_on:
                if d.P_diag.ndim == 1:
                    # shared single-factor form: per-slot rho is a
                    # vector add; per-SCENARIO rho would need the
                    # batched representation
                    if not bool((self.rho == self.rho[:1]).all()):
                        raise ValueError(
                            "active-set compaction of a shared-"
                            "structure batch requires rho uniform "
                            "across scenarios (per-slot vector rho is "
                            "supported; per-scenario rho is not)")
                    d = d._replace(P_diag=d.P_diag.index_add(
                        0, plan.idx_c, self.rho[0, plan.free_slots_dev]))
                else:
                    d = d._replace(P_diag=d.P_diag.index_add(
                        1, plan.idx_c,
                        self.rho.index_select(1, plan.free_slots_dev)))
            self._shrink_factors[key] = (qp_setup(d, q_ref=plan.c_c), d)
        return self._shrink_factors[key]

    def _shrink_dual_fold(self, shrink, w_on, prox_on):
        """The per-iteration dual-bound constant of the compacted system
        (ops/shrink.dual_fold): the base fold plus this iteration's W
        and prox-centre terms of the folded slots."""
        from ..ops.shrink import dual_fold
        fsx = shrink.fixed_slots_dev
        ws = None if self._w_scale is None else self._w_scale[:, fsx]
        return dual_fold(shrink.c0_fold, self._fixed_vals[:, fsx],
                         self.W[:, fsx], self.xbar[:, fsx],
                         self.rho[:, fsx], ws, w_on=bool(w_on),
                         prox_on=bool(prox_on))

    def _shrink_est_hbm(self, n, m):
        """Bytes per iteration of the active-set shapes under the JAX
        package's traffic model (ops/kernels.est_hbm_bytes_per_iter's
        tail), so reports show the bytes tracking the active set."""
        from ..ops import kernels
        chunk = int(self.options.get("subproblem_chunk", 0) or 0) \
            or self.batch.S
        return int(kernels.est_hbm_bytes_per_iter(
            n=n, m=m, s_chunk=min(chunk, self.batch.S))["tail"])

    def maybe_compact(self, nfixed=None):
        """Active-set compaction trigger (DeviceFixer calls it after
        each fixing pass): when the fixed fraction crosses the next
        ``shrink_buckets`` threshold, gather the unfixed columns and the
        rows they touch into a smaller system, re-factorize once per
        mode, and solve THAT until the next transition. Returns True
        when a compaction happened. A no-op unless ``shrink_compact`` is
        on; A is then a dense (m, n) or (S, m, n) tensor (construction
        refuses the split-f32 data, ROADMAP.md A9b).

        A streamed source compacts: one out-of-band full restage
        (booked on ``stream.compacted_restage_bytes``) feeds build_plan,
        the host store re-blocks at the compacted width and the plan's
        per-scenario blocks become 2-row surrogates over it. A
        synthesized source makes full-width blocks on the device and has
        no store to re-block: it keeps fixing through the pin boxes."""
        if not bool(self.options.get("shrink_compact")):
            return False
        if nfixed is None:
            fixed = self._fixed_mask.all(dim=0)
            if self._shard_ops is not None:
                fixed = self.mesh.all_min(fixed.to(torch.uint8)).bool()
            nfixed = int(fixed.sum())
        st = self._shrink_status
        if st is not None:
            st["fixed"], st["free"] = int(nfixed), \
                self.batch.K - int(nfixed)
        frac = nfixed / max(self.batch.K, 1)
        crossed = [b for b in self._shrink_buckets if b <= frac]
        target = crossed[-1] if crossed else None
        current = self._shrink.bucket if self._shrink is not None else 0.0
        if target is None or target <= current:
            return False
        if target in self._shrink_failed:
            # a target whose plan came back None is not staged again
            # every miditer; fixing still pays off through the pin boxes
            return False
        stream = self._stream_source
        if stream is not None and stream.kind != "streamed":
            self._shrink_failed.add(target)
            obs.counter_add("shrink.compaction_skipped")
            return False
        from ..ops import shrink as shrink_ops
        qd, c_full = self.qp_data, self.c
        if stream is not None:
            full = stream.stage_full()
            qd = qd._replace(l=full["l"], u=full["u"], lb=full["lb"],
                             ub=full["ub"])
            c_full = full["c"]
        plan = shrink_ops.build_plan(
            qd, c_full, self.c0, self.nonant_idx,
            self._fixed_mask, self._fixed_vals, target, dtype=self.dtype,
            mesh=self.shard_mesh)
        del qd, c_full
        if self._shard_ops is not None:
            self._assert_same_plan(plan)
        if plan is None:
            self._shrink_failed.add(target)
            obs.counter_add("shrink.compaction_skipped")
            return False
        if stream is not None:
            # re-block the host store at the compacted width, and swap
            # the plan's folded full blocks for surrogates over it: the
            # chunks keep staging per chunk, now compacted
            stream.install_compacted(plan)
            l2, u2, lb2, ub2, c2 = stream.setup_arrays(
                self.dtype, keep_cols=plan.keep_cols_np)
            plan.data_c = plan.data_c._replace(l=l2, u=u2, lb=lb2, ub=ub2)
            plan.c_c = c2
        # capture the surviving warm iterates BEFORE the invalidation
        # drops them (pulled back by the new bucket's first state build)
        self._transplant_capture(plan)
        self._shrink = plan
        self._compact_invalidate()
        obs.counter_add("shrink.compactions")
        obs.gauge_set("shrink.active_cols", plan.n_c)
        obs.gauge_set("shrink.active_rows", plan.m_c)
        if st is not None:
            st["compactions"] += 1
            st["bucket"] = plan.bucket
            st["n_cols"], st["m_rows"] = plan.n_c, plan.m_c
            st["est_hbm_bytes_per_iter"] = self._shrink_est_hbm(
                plan.n_c, plan.m_c)
        obs.event("shrink.compaction", {
            "iter": self._iter, "bucket": plan.bucket,
            "n_cols": plan.n_c, "m_rows": plan.m_c,
            "n_full": plan.n_full, "m_full": plan.m_full,
            "fixed_slots": plan.n_fixed_slots})
        self._trace_note(
            "shrink.note",
            f"shrink: compacted to bucket {plan.bucket:g}: "
            f"{plan.n_c}/{plan.n_full} cols, {plan.m_c}/{plan.m_full} "
            f"rows ({plan.n_fixed_slots} nonants folded out)",
            bucket=plan.bucket, n_cols=plan.n_c, m_rows=plan.m_c)
        return True

    def _assert_same_plan(self, plan):
        """On a sharded mesh every rank must compact to the same system
        (the fixer reads the global x̄, and the kept rows are reduced
        over the ranks): all-reduce a checksum of the plan's index sets
        and raise on every rank when any rank's differs."""
        if plan is None:
            parts = [-1.0, 0.0, 0.0]
        else:
            w = lambda a: float(np.dot(np.asarray(a, np.float64),  # noqa
                                       np.arange(1, len(a) + 1)))
            parts = [float(plan.n_c), w(plan.keep_cols_np),
                     w(plan.keep_rows_np) + w(plan.fixed_slots)]
        v = torch.tensor(parts, dtype=torch.float64, device=self.device)
        if not bool((self.mesh.all_max(v) == self.mesh.all_min(v)).all()):
            raise RuntimeError(
                "ranks built different compaction plans (the plan "
                "checksums differ across the mesh)")
        self._plan_checksum = parts

    def _compact_invalidate(self):
        """A bucket transition changes every hot-loop solve shape: drop
        the warm states (the transplant snapshot, taken just before,
        survives: it is what the new bucket's first state build pulls
        back), the compacted factors, the kernel plans of the compacted
        modes (their launches carry into ``_retired_launches``; the
        block's split schedule is a function of (m, n), so a plan of
        another width cannot serve), the chunk plumbing and the
        recovery bookkeeping. The FULL-system factor cache survives:
        the full (A, P, rho) are unchanged, and the fixed-mode and
        full-width consumers keep using it."""
        self._shrink_factors.clear()
        self._qp_states.clear()
        self._chunk_states.clear()
        self._dispatch_stores.clear()
        for key in [k for k in self._kernel_plans if isinstance(k, bool)]:
            self._retired_launches += self._kernel_plans.pop(key).launches
        self._chunk_no_retry.clear()
        self._hospital_no_retry.clear()
        self._blacklist_calls.clear()
        self._chunk_idx_cache.clear()
        self._pool_states.clear()

    # ---- cross-bucket warm transplant ----
    def _transplant_book_cold(self, reason):
        obs.counter_add("shrink.transplant_cold_fallbacks")
        if self._shrink_status is not None:
            self._shrink_status["transplant_cold"] += 1
        obs.event("shrink.transplant_cold",
                  {"iter": self._iter, "reason": reason})

    def _transplant_fields(self, mode):
        """One mode's warm SCALED ADMM iterates as full-(S, ·) tensors,
        or None when the mode has nothing cached. The port's chunk view
        holds the scaled iterates of the per-chunk states (pads
        trimmed), and the dispatch store is a full-width QPState, so the
        mode's cached state serves in every layout."""
        st = self._qp_states.get(mode)
        if st is None or st.x.shape[0] != self.batch.S:
            return None
        return {f: getattr(st, f) for f in ("x", "yA", "yB", "zA", "zB")}

    def _transplant_capture(self, plan_new):
        """Snapshot each hot-loop mode's warm iterates at a bucket
        transition, for the NEW plan: only the iterates, the old
        factors' scaling vectors (D, E, Eb, cost_scale) and the old
        plan's geometry, never whole factors. A scenario fails the
        capture gate, and restarts cold, when its iterates do not
        certify themselves (x ≈ zB and A·x ≈ zA after unscaling: a
        hospital-rescued row keeps diverged iterates under its clean
        residuals) or when the hospital gave it up."""
        self._transplant_src = None
        if not bool(self.options.get("shrink_transplant", True)):
            return
        from ..ops.qp_solver import _Ax
        S = self.batch.S
        old = self._shrink
        modes = {}
        for mode in (True, False):
            fields = self._transplant_fields(mode)
            if fields is None:
                continue
            if old is not None:
                ent = self._shrink_factors.get(mode) \
                    or next(iter(self._shrink_factors.values()), None)
            else:
                ent = self._factors.get(mode)
            if ent is None:
                self._transplant_book_cold("no source factors")
                continue
            fac = ent[0]

            def b2(v):
                return v if v.ndim == 2 else v.unsqueeze(0)

            x_u = fields["x"] * b2(fac.D)
            zB_u = fields["zB"] / b2(fac.Eb)
            zA_u = fields["zA"] / b2(fac.E)
            ax_u = _Ax(ent[1].A, x_u)
            gap = torch.maximum((x_u - zB_u).abs().amax(dim=1),
                                (ax_u - zA_u).abs().amax(dim=1))
            scale = torch.maximum(
                torch.maximum(torch.ones_like(gap),
                              x_u.abs().amax(dim=1)),
                ax_u.abs().amax(dim=1))
            gate = max(100 * _hot_eps(bool(mode), self.sub_eps,
                                      self.sub_eps_hot), 1e-2)
            ok = to_host(torch.isfinite(gap) & (gap / scale <= gate))
            for g in self._hospital_no_retry.get(mode, ()):
                if g < S:
                    ok[g] = False
            modes[mode] = {
                "st": fields,
                "fac": {"D": fac.D, "E": fac.E, "Eb": fac.Eb,
                        "cs": fac.cost_scale},
                "keep_cols": None if old is None else old.keep_cols_np,
                "keep_rows": None if old is None else old.keep_rows_np,
                "shift": None if old is None else old.rhs_shift,
                "ok": ok}
        if modes:
            self._transplant_src = {"bucket": plan_new.bucket,
                                    "modes": modes}

    def _transplant_pull(self, key, factors_new):
        """The captured warm iterates rescaled into the CURRENT plan's
        geometry (ops/shrink._transplant_rescale), or None when no
        snapshot applies. Books ``shrink.transplant_cold_fallbacks``
        only when a snapshot for this plan exists and a guard rejects
        it; no snapshot is the ordinary cold build."""
        src = self._transplant_src
        plan = self._shrink
        if src is None or plan is None or src["bucket"] != plan.bucket \
                or not isinstance(key, bool):
            return None
        mode = key if key in src["modes"] else next(iter(src["modes"]),
                                                      None)
        ent = src["modes"].get(mode)
        if ent is None:
            return None
        new_keep, new_rows = plan.keep_cols_np, plan.keep_rows_np
        old_keep = ent["keep_cols"]
        if old_keep is None:
            old_keep = np.arange(plan.n_full)
        old_rows = ent["keep_rows"]
        if old_rows is None:
            old_rows = np.arange(plan.m_full)
        st = ent["st"]
        # buckets only ever FIX more slots, so the new kept set nests in
        # the old one; anything else is not a gather and restarts cold
        if st["x"].shape[-1] != old_keep.size \
                or st["zA"].shape[-1] != old_rows.size \
                or new_keep.size > old_keep.size \
                or new_rows.size > old_rows.size:
            self._transplant_book_cold("width mismatch")
            return None
        if not (np.isin(new_keep, old_keep).all()
                and np.isin(new_rows, old_rows).all()):
            self._transplant_book_cold("active set not nested")
            return None
        dev = self.device
        pos_c = torch.as_tensor(np.searchsorted(old_keep, new_keep),
                                device=dev)
        pos_r = torch.as_tensor(np.searchsorted(old_rows, new_rows),
                                device=dev)
        shift_old = ent["shift"]
        if shift_old is None:
            # full-width source: no rhs fold
            shift_old = torch.zeros((1, int(plan.m_full)),
                                    dtype=plan.rhs_shift.dtype, device=dev)
        fac_o = ent["fac"]
        cs_ratio = factors_new.cost_scale / fac_o["cs"]
        from ..ops.shrink import _transplant_rescale
        x_n, yA_n, yB_n, zA_n, zB_n = _transplant_rescale(
            st["x"], st["yA"], st["yB"], st["zA"], st["zB"], pos_c, pos_r,
            fac_o["D"], factors_new.D, fac_o["E"], factors_new.E,
            fac_o["Eb"], factors_new.Eb, cs_ratio, shift_old,
            plan.rhs_shift, torch.as_tensor(ent["ok"], device=dev))
        obs.counter_add("shrink.transplants")
        if self._shrink_status is not None:
            self._shrink_status["transplants"] += 1
        obs.event("shrink.transplant", {
            "iter": self._iter, "mode": _mode_str(mode),
            "bucket": plan.bucket, "n_cols": plan.n_c,
            "cold_rows": int((~ent["ok"]).sum())})
        return {"x": x_n, "yA": yA_n, "yB": yB_n, "zA": zA_n, "zB": zB_n}

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
            cold = qp_cold_state(factors, d)
            if st.x.shape[-1] == cold.x.shape[-1] \
                    and st.zA.shape[-1] == cold.zA.shape[-1]:
                st = cold._replace(x=st.x, yA=st.yA, yB=st.yB, zA=st.zA,
                                   zB=st.zB)
            else:
                st = self._warm_from_transplant(key, factors, cold)
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
            else:
                # no same-width sibling: the cross-bucket snapshot
                # (maybe_compact -> _transplant_capture) warm starts a
                # new compacted geometry instead of cold zeros
                st = self._warm_from_transplant(key, factors, st)
            self._qp_states[key] = st
        return self._qp_states[key]

    def _warm_from_transplant(self, key, factors, cold):
        """``cold`` with the transplanted iterates when a snapshot
        applies at its shapes, else ``cold``."""
        tp = self._transplant_pull(key, factors)
        if tp is not None and tp["x"].shape == cold.x.shape \
                and tp["zA"].shape == cold.zA.shape:
            return cold._replace(**tp)
        return cold

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

    def _ensure_chunk_states(self, key, factors, data, slices,
                             cold_data=None):
        """Per-chunk QPStates, the authoritative store of chunked mode
        (each chunk owns its rho_scale / factor trajectory). ONE cold
        state serves every chunk, factor included: chunk shapes are
        identical and nothing on the chunked path writes a state's
        tensors in place, so the sharing is safe. A new mode transplants
        its iterates from another mode's (concatenated) state, as
        _ensure_state does. ``cold_data``: one chunk-shaped data block
        for the cold state (a scenario source's direct fetch), instead
        of chunk 0's rows of ``data``."""
        if key not in self._chunk_states:
            # any mode's state, this mode's own included (as the JAX
            # package reads it)
            other = self._warm_source()
            d0 = cold_data
            if d0 is None:
                idx0 = slices[0][0]
                d0 = data._replace(l=data.l[idx0], u=data.u[idx0],
                                   lb=data.lb[idx0], ub=data.ub[idx0])
            st0 = qp_cold_state(factors, d0)
            transplant = other is not None \
                and other.x.shape[0] == self.batch.S \
                and other.zA.shape[1] == st0.zA.shape[1] \
                and other.x.shape[-1] == st0.x.shape[-1]
            if not transplant:
                # no same-width sibling mode: the cross-bucket snapshot,
                # rescaled into this geometry, when one applies
                other = self._transplant_pull(key, factors)
                transplant = other is not None \
                    and other["x"].shape[-1] == st0.x.shape[-1] \
                    and other["zA"].shape[-1] == st0.zA.shape[-1]
                if transplant:
                    other = SimpleNamespace(**other)
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
        last chunk's (chunking needs a shared A, so L is (n, n)). With a
        scenario source the cold template's chunk-shaped block is one
        direct fetch (once per store rebuild)."""
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
            if self._stream_source is not None:
                b0 = self._stream_source.fetch(0)
                d0 = data._replace(l=b0["l"], u=b0["u"], lb=b0["lb"],
                                   ub=b0["ub"])
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

    def _dispatch_slices(self, dispatch, chunk):
        """(slices, padded ids) of a dispatch-masked pass: the ascending
        id list microbatched into full ``chunk``-row chunks, the last
        padded by repeating the last id (the _chunk_index convention).
        Books the dispatch counters."""
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
        with self._scope():
            return self._solve_loop(w_on, prox_on, update, fixed, dispatch)

    def _mode_entry(self, skey):
        """The phase-timing record of one mode key: "sharded" over the
        mesh's ranks, else "host" on one device."""
        return self._phase_times.setdefault(
            skey, {"acc": {"assemble": 0.0, "solve": 0.0, "gate": 0.0,
                           "reduce": 0.0},
                   "calls": 0, "gate_syncs": 0,
                   "devices": 1 if self._shard_ops is None
                   else self._shard_ops.n_devices,
                   "mode": "host" if self._shard_ops is None
                   else "sharded"})

    def _local_chunk(self, chunk):
        """The chunk rows of the chunked loop: ``subproblem_chunk``, or
        on a sharded mesh the per-rank chunk rounded so every chunk is
        a full local slice of every shard (core/spbase pads S from the
        same parallel/mesh.local_chunk_layout, so it divides the
        shard)."""
        if self._shard_ops is None:
            return chunk
        from ..parallel.mesh import local_chunk_layout
        return local_chunk_layout(self._shard_ops.shard_size, chunk)[1]

    def _solve_loop(self, w_on, prox_on, update, fixed, dispatch):
        obs.counter_add("ph.solve_loop_calls")
        chunk = int(self.options.get("subproblem_chunk", 0) or 0)
        # on a mesh, ``subproblem_chunk`` bounds the PER-RANK microbatch
        chunked = 0 < chunk < self.batch.S
        if self._stream_source is not None and not chunked:
            raise ValueError(
                "scenario streaming serves the CHUNKED hot loop only: "
                "subproblem_chunk must be positive and below the "
                f"(per-rank) scenario count (got chunk={chunk}, "
                f"S={self.batch.S})")
        if dispatch is not None:
            if self._shard_ops is not None:
                raise ValueError(
                    "dispatch-masked solves run unsharded; a sharded "
                    "APH uses masked acceptance")
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
            return self._solve_loop_chunked(
                self._local_chunk(chunk), w_on, prox_on, update, fixed,
                dispatch=dispatch)
        qp_state = self._ensure_state(prox_on, fixed)
        factors, data = self._get_factors(prox_on, fixed)
        skey = ("fixed", bool(prox_on)) if fixed else bool(prox_on)
        ent = self._mode_entry(skey)
        ent["calls"] += 1
        plan = self._kernel_plan(skey, factors)
        ent["kernel"] = plan.descriptor()
        acc = ent["acc"]
        sp_args = {"mode": _mode_str(skey)} if obs.enabled() else None
        t_mark = _time.perf_counter()

        def _lap(phase):
            nonlocal t_mark
            now = _time.perf_counter()
            acc[phase] += now - t_mark
            # the span shares _lap's own perf_counter marks, so the
            # trace's totals are exactly phase_timing's
            obs.complete_span(_PHASE_SPAN[phase], t_mark, now, cat="ph",
                              args=sp_args)
            t_mark = now

        shrink = self._shrink if not fixed else None
        step = _ph_step if shrink is None else self._shrink_step
        (qp_state, x, yA, yB, xn, xbar_new, xsqbar_new, W_new, conv,
         base_obj, solved_obj, dual_obj) = step(
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
            lap=_lap, kernel=plan, shard_ops=self._shard_ops)
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

    def _assembly_operands(self, shrink):
        """The assemble-side operands of a hot-loop solve: the cost, the
        hub's (S, K) blocks and the nonant column index, gathered to the
        free slots and the compacted columns under a shrink plan."""
        if shrink is None:
            return {"c": self.c, "W": self.W, "xbar": self.xbar,
                    "rho": self.rho, "fm": self._fixed_mask,
                    "fv": self._fixed_vals, "ws": self._w_scale,
                    "idx": self.nonant_idx}
        fs = shrink.free_slots_dev
        return {"c": shrink.c_c, "W": self.W[:, fs],
                "xbar": self.xbar[:, fs], "rho": self.rho[:, fs],
                "fm": self._fixed_mask[:, fs],
                "fv": self._fixed_vals[:, fs],
                "ws": None if self._w_scale is None
                else self._w_scale[:, fs], "idx": shrink.idx_c}

    def _shrink_step(self, qp_state, factors, data, c, c0, P0, prob,
                     xbar_w, memberships, idx, W, xbar, rho, fixed_mask,
                     fixed_vals, wscale, *, w_on, prox_on, slot_slices,
                     lap, kernel, shard_ops=None, **solve_kw):
        """_ph_step on the compacted system (the arguments are
        _ph_step's): assemble on the free-slot blocks, solve the
        compacted system, expand, then reduce on the FULL blocks, so
        x̄, W and conv come from the uncompacted path's arithmetic."""
        from ..ops.shrink import expand_solution
        shrink = self._shrink
        asm = self._assembly_operands(shrink)
        q_c, bl_c, bu_c = _ph_assemble(
            data, asm["c"], asm["W"], asm["xbar"], asm["rho"], asm["idx"],
            asm["fm"], asm["fv"], asm["ws"], w_on=w_on, prox_on=prox_on)
        d_c = data._replace(lb=bl_c, ub=bu_c)
        lap("assemble")
        qp_state, x_c, yA, yB = _solver_call(
            factors, d_c, q_c, qp_state, prox_on=prox_on, kernel=kernel,
            **solve_kw)
        if kernel is not None and kernel.mode == "fused" and obs.enabled():
            obs.counter_add("kernel.fused_iters", int(qp_state.iters))
        lap("solve")
        x = expand_solution(x_c, shrink.fixed_colvals, shrink.keep_cols,
                            shrink.fixed_cols, shrink.n_full)
        xn, base_obj, solved_obj = _shrink_objs(x, c, c0, P0, W, idx,
                                                w_on=w_on)
        dual_obj = _shrink_dual(
            d_c, q_c, self._shrink_dual_fold(shrink, w_on, prox_on), yA,
            yB, x_c)
        wmask = None if wscale is None else wscale > 0
        xbar_new, xsqbar_new, W_new, conv = _ph_combine(
            xn, prob, xbar_w, memberships, W, rho, wmask,
            slot_slices=slot_slices, shard_ops=shard_ops)
        lap("reduce")
        return qp_state, x, yA, yB, xn, xbar_new, xsqbar_new, W_new, \
            conv, base_obj, solved_obj, dual_obj

    def _stream_bind(self, stream, slices, chunk, ids_pad, shrink):
        """Bind the scenario source to this pass's layout: chunk ci's
        local rows in chunk-row order (the gate's and the hospital's
        slice maps). A full pass re-binds only when the layout changes
        (the ids come to the host once per layout); a dispatch pass
        binds this iteration's id set, so only the dispatched chunks
        stage, under a sequence number that makes each partial pass a
        fresh layout. The compacted width is part of the layout."""
        S = self.batch.S
        if ids_pad is not None:
            self._dispatch_bind_seq = \
                getattr(self, "_dispatch_bind_seq", 0) + 1
            lkey = ("dispatch", chunk, S, self._dispatch_bind_seq)
        else:
            lkey = ("host", chunk, S)
        if shrink is not None:
            lkey = lkey + ("compact", shrink.bucket, shrink.n_c)
        if stream.bound_key == lkey:
            return
        if ids_pad is not None:
            ids = [ids_pad[i * chunk:(i + 1) * chunk]
                   for i in range(len(slices))]
        else:
            ids = [idx.cpu().numpy() for idx, _ in slices]
        stream.bind(lkey, ids, compacted=shrink is not None)

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

        With a scenario source (``scenario_source``, core/spbase) the
        five vector fields of each chunk come from the source instead of
        resident rows: the pass binds the source to its layout, pass 1
        assembles each chunk as it arrives (chunk k+1 is staged while
        chunk k solves), the records keep no data blocks, retries and
        the hospital fetch directly, and pass 3 restages the chunks in a
        second in-order pass.

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
        stream = self._stream_source
        shrink = self._shrink if not fixed else None
        ids_pad = None
        if dispatch is None:
            slices = self._chunk_index(chunk)
        else:
            slices, ids_pad = self._dispatch_slices(dispatch, chunk)
        cold_d = None
        if stream is not None:
            self._stream_bind(stream, slices, chunk, ids_pad, shrink)
            if dispatch is None and key not in self._chunk_states:
                # cold chunk states need one chunk-shaped block: a direct
                # fetch (once per mode rebuild, never steady-state)
                b0 = stream.fetch(0)
                cold_d = data._replace(l=b0["l"], u=b0["u"], lb=b0["lb"],
                                       ub=b0["ub"])
        if dispatch is None:
            states = self._ensure_chunk_states(key, factors, data, slices,
                                               cold_data=cold_d)
        else:
            from ..ops.dispatch import gather_rows
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
        ent = self._mode_entry(key)
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

        # active-set compaction (ops/shrink): the hot-loop modes solve
        # the compacted system (``factors`` and ``data`` above are
        # compacted already); the (S, K) hub blocks gather to the free
        # slots for assembly, and pass 3 expands solutions back to full
        # width
        asm = self._assembly_operands(shrink)
        c0fold = None if shrink is None else self._shrink_dual_fold(
            shrink, w_on, prox_on)

        # record layout (indices 0-3 are the _hospitalize contract):
        #  [st, x, yA, yB, d_c, q_c, factors]
        def _assemble(ci):
            idx_c, _ = slices[ci]
            d_c = data._replace(l=data.l[idx_c], u=data.u[idx_c],
                                lb=data.lb[idx_c], ub=data.ub[idx_c])
            ws = None if asm["ws"] is None else asm["ws"][idx_c]
            q_c, bl_c, bu_c = _ph_assemble(
                d_c, asm["c"][idx_c], asm["W"][idx_c], asm["xbar"][idx_c],
                asm["rho"][idx_c], asm["idx"], asm["fm"][idx_c],
                asm["fv"][idx_c], ws, w_on=bool(w_on),
                prox_on=bool(prox_on))
            return d_c._replace(lb=bl_c, ub=bu_c), q_c

        def _stream_assemble(ci, direct=False):
            """_assemble with the five vector fields from the scenario
            source (prefetched in order; ``direct`` bypasses the
            pipeline for a retry). Returns (d_c, q_c, c_c): pass 3
            needs the chunk's cost, and the records keep no data
            blocks. Under a shrink plan the source stages compacted
            l/u/lb/ub and the FULL c, whose kept columns assemble (a
            gather, so q equals the resident plan.c_c spelling)."""
            blk = stream.fetch(ci) if direct else stream.chunk(ci)
            idx_c, _ = slices[ci]
            d_c = data._replace(l=blk["l"], u=blk["u"], lb=blk["lb"],
                                ub=blk["ub"])
            c_blk = blk["c"]
            c_asm = c_blk if shrink is None \
                else c_blk.index_select(1, shrink.keep_cols)
            ws = None if asm["ws"] is None else asm["ws"][idx_c]
            q_c, bl_c, bu_c = _ph_assemble(
                d_c, c_asm, asm["W"][idx_c], asm["xbar"][idx_c],
                asm["rho"][idx_c], asm["idx"], asm["fm"][idx_c],
                asm["fv"][idx_c], ws, w_on=bool(w_on),
                prox_on=bool(prox_on))
            return d_c._replace(lb=bl_c, ub=bu_c), q_c, c_blk

        # a scenario source stages chunks in order under the solves (a
        # gated pass: chunk k+1 is copied while chunk k solves); its
        # assembly stays in the solve loop, since enqueueing every chunk
        # up front would hold every chunk's blocks at once
        if stream is not None:
            stream.begin_pass(gated=True)
            inputs = None
        else:
            inputs = [_assemble(ci) for ci in range(len(slices))] \
                if pipeline else None
        _lap("assemble")

        # pass 1 — SOLVE
        solved_chunks = [None] * len(slices)
        prev_st = None
        for ci in range(len(slices)):
            if stream is not None:
                t_a = _time.perf_counter()
                d_c, q_c, _ = _stream_assemble(ci)
                stream.release(ci)
                dt_a = _time.perf_counter() - t_a
                acc["assemble"] += dt_a
                t_mark += dt_a
            elif pipeline:
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
                                    "devices": ent["devices"]})
            prev_st = st
            if split_mode:
                # record a STRIPPED state: each chunk's factor kept until
                # pass 3 would pin every refactorized copy at once (the
                # unify below re-attaches the flowed one)
                st = st._replace(L=None)
            # streamed records drop the data blocks once the solve is
            # enqueued (passes 2 and 3 restage them): holding every
            # chunk's blocks would be the residency streaming bounds
            hold = stream is None
            solved_chunks[ci] = [st, x, yA, yB, d_c if hold else None,
                                 q_c if hold else None, factors]
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
        # On a sharded mesh the gate is every rank's rows, gathered by
        # one all-reduce before the ONE read: ``pri_glob`` (ranks,
        # chunks, rows) is the same on every rank, so every rank takes
        # the same retry and hospital decisions; ``pri_host`` is this
        # rank's plane of it (a view: writes land in both)
        sh = self._shard_ops
        if pipeline or sh is not None:
            pri_dev = stacked_residuals([rec[0] for rec in solved_chunks])
            if sh is not None:
                pri_dev = self.mesh.gather_rows(pri_dev.unsqueeze(0),
                                                sh.n_devices)
            pri_glob = pri_dev.cpu().numpy().copy()
            if sh is None:
                pri_glob = pri_glob[None]
            gate_syncs += 1
        else:
            pri_glob = np.stack([rec[0].pri_rel.cpu().numpy()
                                 for rec in solved_chunks])[None]
            gate_syncs += len(solved_chunks)
        me = 0 if sh is None else self.mesh.rank
        pri_host = pri_glob[me]
        if obs.enabled():
            obs.counter_add("xfer.d2h_bytes", pri_glob.nbytes)
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
            m = float(pri_glob[:, ci].max())
            is_nan = not np.isfinite(m)
            # the blacklist stops repeated retries of a hard chunk, but
            # NaN iterates are always replaced: stored, they would
            # poison every later warm start
            if (m <= thr) or (ci in no_retry and not is_nan):
                continue
            fac_c, d_r, q_r = rec[6], rec[4], rec[5]
            if stream is not None:
                d_r, q_r, _ = _stream_assemble(ci, direct=True)
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
            # the retry's own sync (every rank's rows of the chunk)
            pri2 = st2.pri_rel if sh is None else self.mesh.gather_rows(
                st2.pri_rel.unsqueeze(0), sh.n_devices)
            pri2 = pri2.cpu().numpy().reshape(pri_glob[:, ci].shape)
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
                pri_glob[:, ci] = pri2
            elif is_nan:
                # both attempts NaN: keep the clean cold state so the
                # next iteration starts from finite values
                rec[:4] = [st_r, st_r.x, st_r.yA, st_r.yB]
                pri_glob[:, ci] = np.inf
            if not (m2 <= thr):
                no_retry.add(ci)
        # pass 2b — the scenario hospital. Not for split data: its
        # per-scenario (cap, m, n) batched factors are what the df32
        # representation exists to avoid; df32 relies on chunk retries
        # and blacklist re-admission
        if bool(self.options.get("subproblem_hospital", True)) \
                and not isinstance(data.A, (SplitMatrix, ScaledView)):
            gate_syncs += self._hospitalize(key, slices, solved_chunks,
                                            data, thr, bool(w_on),
                                            bool(prox_on), kw,
                                            pri_glob=pri_glob,
                                            shrink=shrink)
        # standing casualties: rows still above the gate enter x̄/W with
        # their loose solutions this iteration; say so when anything
        # listens
        if self._trace_consumers_active():
            standing = []
            for ci, (idx_c, real) in enumerate(slices):
                pr = pri_host[ci][:real]
                bad = np.flatnonzero(~(pr <= thr))
                if bad.size:
                    ids = [self._row0 + i for i in idx_c.tolist()]
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
        # a scenario source restages each chunk through a second in-order
        # pass: the reassembled (d, q) equal pass 1's (W, x̄, rho and the
        # fixings move only after this pass), and the RAW shared P row
        # broadcasts (the objective carries no prox rho)
        if stream is not None:
            stream.begin_pass()
        parts = {k: [] for k in ("x", "yA", "yB", "xn", "base", "solved",
                                 "dual")}
        for ci, (idx_c, real) in enumerate(slices):
            st, x, yA, yB, d_h, q_h, _ = solved_chunks[ci]
            states[ci] = st
            if stream is not None:
                d_h, q_h, c_ci = _stream_assemble(ci)
                P0_ci = self.qp_data.P_diag.expand(c_ci.shape)
            else:
                c_ci, P0_ci = self.c[idx_c], self.P_diag[idx_c]
            if shrink is not None:
                # expand to full width (the fixed columns take their
                # folded values) and evaluate the objectives on the FULL
                # cost structures; the dual bound stays on the compacted
                # system plus the fold
                from ..ops.shrink import expand_solution
                x_c = x
                x = expand_solution(x_c, shrink.fixed_colvals[idx_c],
                                    shrink.keep_cols, shrink.fixed_cols,
                                    shrink.n_full)
                xn, base, solved = _shrink_objs(
                    x, c_ci, self.c0[idx_c], P0_ci, self.W[idx_c],
                    self.nonant_idx, w_on=bool(w_on))
                dual = _shrink_dual(d_h, q_h, c0fold[idx_c], yA, yB, x_c)
            else:
                xn, base, solved, dual = _ph_chunk_objs(
                    x, yA, yB, d_h, q_h, c_ci, self.c0[idx_c], P0_ci,
                    self.nonant_idx, self.W[idx_c], w_on=bool(w_on))
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
                slot_slices=self.slot_bounds, shard_ops=self._shard_ops)
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
                     prox_on, kw, pri_glob=None, shrink=None):
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

        ``pri_glob``: the gate's (ranks, n_chunks, chunk) host residual
        array (one rank without a sharded mesh); cured rows are written
        back into it. On a sharded mesh the picks come from every rank's
        rows, each rank assembles the rows it owns (with their rows of P
        and A where those are per scenario) into zero buffers that one
        all-reduce fills, and every rank solves the same rescue batch
        locally (no collective inside the solve) and keeps its own rows. Under a shrink plan (``shrink``) ``data`` is the compacted
        system and the rescue assembles from the compacted cost and the
        free-slot hub blocks, so it solves the system the chunks solve
        and its rows scatter back at the compacted width. With a
        scenario source the picked rows stage from it (a direct fetch: a
        host gather or synthesis on the device), and its full c gathers
        the kept columns under a plan. Returns the number of host
        transfers made (0 or 1)."""
        cap = int(self.options.get("subproblem_hospital_max", 4))
        failed = self._hospital_no_retry.setdefault(key, set())
        sh = self._shard_ops
        L = self.batch.S
        me = 0 if sh is None else self.mesh.rank
        picks = []               # (chunk, rank, row, scenario, pri_rel)
        for ci, (idx_c, real) in enumerate(slices):
            ids = idx_c.tolist()
            for d in range(1 if sh is None else sh.n_devices):
                pr = (solved_chunks[ci][0].pri_rel.cpu().numpy()
                      if pri_glob is None else pri_glob[d, ci])[:real]
                for r in np.flatnonzero(~(pr <= thr)):
                    # keyed by GLOBAL scenario id: chunk-local
                    # coordinates would re-target other scenarios if
                    # the chunk changed
                    g = d * L + ids[r]
                    if g not in failed and g < self._S_orig:
                        picks.append((ci, d, int(r), g, float(pr[r])))
        if not picks:
            return 0
        picks.sort(key=lambda t: -t[4])     # worst first under the cap
        picks = picks[:cap]
        # selection row j -> (owning rank, local row); pads repeat pick 0
        owners = [(d, g - d * L) for _, d, _, g, _ in picks]
        owners += [owners[0]] * (cap - len(owners))
        k = len(owners)
        asm = self._assembly_operands(shrink)
        n = int(data.lb.shape[-1])
        mine = [j for j, (d, _) in enumerate(owners) if d == me]
        loc_np = np.asarray([owners[j][1] for j in mine], dtype=np.int64)
        loc_t = torch.as_tensor(loc_np, device=self.device)
        P_m = data.P_diag.expand(len(mine), n) if data.P_diag.ndim == 1 \
            else data.P_diag[loc_t]
        A_b = data.A.expand(len(mine), *data.A.shape) if data.A.ndim == 2 \
            else data.A[loc_t]
        stream = self._stream_source
        if stream is not None:
            rb = stream.rows(loc_np)
            d_m = QPData(P_m, A_b, rb["l"], rb["u"], rb["lb"], rb["ub"])
            c_m = rb["c"] if shrink is None \
                else rb["c"].index_select(1, shrink.keep_cols)
        else:
            d_m = QPData(P_m, A_b, data.l[loc_t], data.u[loc_t],
                         data.lb[loc_t], data.ub[loc_t])
            c_m = asm["c"][loc_t]
        ws = None if asm["ws"] is None else asm["ws"][loc_t]
        q_m, bl_m, bu_m = _ph_assemble(
            d_m, c_m, asm["W"][loc_t], asm["xbar"][loc_t],
            asm["rho"][loc_t], asm["idx"], asm["fm"][loc_t],
            asm["fv"][loc_t], ws, w_on=w_on, prox_on=prox_on)
        rows = {"l": d_m.l, "u": d_m.u, "lb": bl_m, "ub": bu_m, "q": q_m}
        if data.P_diag.ndim != 1:
            rows["P"] = d_m.P_diag
        if sh is not None:
            # every rank's picked rows on every rank: exact, each row
            # has one writer; a per-scenario A travels with its rows
            if data.A.ndim == 3:
                rows["A"] = A_b.flatten(1)
            sel_t = torch.as_tensor(mine, dtype=torch.long,
                                    device=self.device)
            packed = torch.cat([v for v in rows.values()], dim=1)
            buf = torch.zeros((k, packed.shape[1]), dtype=packed.dtype,
                              device=self.device)
            buf = self.mesh.all_sum(buf.index_copy(0, sel_t, packed))
            off = 0
            for name, v in list(rows.items()):
                rows[name] = buf[:, off:off + v.shape[1]]
                off += v.shape[1]
            A_b = data.A.expand(k, *data.A.shape) if data.A.ndim == 2 \
                else rows["A"].reshape(k, *data.A.shape[1:])
        P_b = data.P_diag.expand(k, n) if data.P_diag.ndim == 1 \
            else rows["P"]
        d_h = QPData(P_b, A_b, rows["l"], rows["u"], rows["lb"],
                     rows["ub"])
        q_h = rows["q"]
        # native precision, a larger budget and long segments: the
        # batch is a few rows, and every rank solves all of them
        with mesh_scope(None):
            fac_h = qp_setup(d_h, q_ref=q_h)
            st_h = qp_cold_state(fac_h, d_h)
            st_h, x_h, yA_h, yB_h = _solver_call(
                fac_h, d_h, q_h, st_h,
                **dict(kw, precision="native", kernel=None,
                       sub_max_iter=max(6000, kw["sub_max_iter"]),
                       segment=1500))
        pr_h = st_h.pri_rel.cpu().numpy()
        obs.counter_add("ph.hospital_treated", len(picks))
        worst = " ".join(
            f"s{g}:{pr_old:.0e}->{pr_h[j]:.0e}"
            for j, (_, _, _, g, pr_old) in enumerate(picks))
        self._trace_note(
            "ph.hospital",
            f"hospital: treated {len(picks)} scenario(s) [{worst}]",
            treated=len(picks),
            scenarios=[{"scenario": g, "pri_rel_before": pr_old,
                        "pri_rel_after": float(pr_h[j])}
                       for j, (_, _, _, g, pr_old) in enumerate(picks)])
        for j, (ci, d, r, g, pr_old) in enumerate(picks):
            if not (pr_h[j] <= thr):
                # one shot per scenario until re-admission; an improved
                # row still gets its better solution below
                failed.add(g)
            if not (pr_h[j] < pr_old):
                continue
            if pri_glob is not None:
                pri_glob[d, ci, r] = pr_h[j]
            if d != me:
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
        pri, dua = self._real_rows(st.pri_rel, st.dua_rel)
        return {"pri_rel_max": float(pri.max()),
                "pri_rel_mean": float(pri.mean()),
                "dua_rel_max": float(dua.max()),
                "dua_rel_mean": float(dua.mean())}

    def _forensic_sample(self, it):
        """One wheel-forensics sample (ops/forensics.py): the
        attribution reduction over the current (S, K) hub state on the
        device, its packed result fetched once at the iteration record,
        after the iteration's gate synced (``ph.gate_syncs`` does not
        move), unpacked and handed to the diagnosis engine. On a
        sharded mesh every rank takes part in the reduction's
        collectives and packs the unsharded sample. Returns the sample
        dict, or None when the state is not ready."""
        if self.x is None or self.conv is None:
            return None
        from ..obs import diagnose as _obs_diagnose
        from ..ops import forensics as _forensics
        xn = self.nonants_of(self.x)
        S, K = xn.shape
        st = self._forensic_state
        if st is None or st.prev_w.shape != (S, K):
            # first sample, or a shrink compaction changed the slot
            # width: restart the carry (validity gates re-arm)
            st = _forensics.init_state(S, K, dtype=xn.dtype,
                                       device=xn.device)
        kk = min(_forensics.TOPK, K)
        ks = min(_forensics.TOPK, int(self._S_orig))
        sh = self._shard_ops
        st, packed = _forensics.forensic_reduce(
            st, xn, self.xbar, self.W, self.prob, self.rho, kk=kk, ks=ks,
            mesh=None if sh is None else self.mesh,
            row_offset=0 if sh is None else self.mesh.row_range(sh.S)[0])
        self._forensic_state = st
        fx = _forensics.unpack(packed, kk, ks)
        fx["it"] = int(it)
        fx["n_scens"] = int(self._S_orig)
        fx["n_slots"] = int(K)
        shrink = None
        if self._shrink_status is not None:
            shrink = dict(self._shrink_status)
            buckets = getattr(self, "_shrink_buckets", None)
            if buckets:
                shrink["first_bucket"] = float(buckets[0])
        _obs_diagnose.note_sample(fx, shrink=shrink)
        self._forensic_last = fx
        return fx

    # counters whose per-iteration deltas enter the ph.iteration record
    # (the JAX package's list; a port run books no jax.* counters, so
    # jax.compiles never shows in its deltas)
    _ITER_DELTA_COUNTERS = ("ph.gate_syncs", "ph.chunk_retries",
                            "ph.hospital_treated", "ph.standing_rows",
                            "ph.blacklist_readmitted", "qp.donated_passes",
                            "qp.solve_segments", "jax.compiles",
                            # sharded engines: collective bytes > 0 and
                            # device_put bytes == 0 in steady state
                            "xfer.collective_bytes",
                            "xfer.device_put_bytes",
                            # APH φ-dispatch (ops/dispatch): gate syncs
                            # and solved vs skipped scenario counts
                            "aph.gate_syncs",
                            "dispatch.solved_scenarios",
                            "dispatch.skipped_scenarios",
                            "dispatch.bucket.compile",
                            "dispatch.bucket.cache_hit",
                            # kernel-backend activity (ops/kernels)
                            "kernel.fused_iters",
                            "kernel.l_inv_factorizations",
                            "kernel.bf16_fallbacks",
                            # scenario streaming (stream/): the
                            # steady-state flatness analyze asserts
                            "stream.chunks_shipped",
                            "stream.bytes_shipped",
                            "stream.synth_chunks",
                            "stream.prefetch_stalls",
                            "stream.direct_fetches",
                            "stream.compacted_transitions",
                            "stream.compacted_restage_bytes",
                            # progressive shrinking (ops/shrink)
                            "shrink.fixed_new",
                            "shrink.compactions",
                            "shrink.transplants",
                            "shrink.transplant_cold_fallbacks",
                            # measured roofline (obs/profile.py): the
                            # analytic FLOPs and bytes booked THIS
                            # iteration
                            "profile.flops",
                            "profile.hbm_bytes")

    def iteration_record(self, it, seconds, phase_before, counters_before):
        """The structured per-iteration convergence record (the JAX
        package's): conv, residual summary, best bounds + gap as
        currently known, this iteration's phase wall-clocks and counter
        deltas, the shrink / stream / aph / sharding blocks where the
        engine has them, the measured roofline and, on the forensics
        interval, a forensic sample. Emitted as the ``ph.iteration``
        event; only assembled when telemetry is enabled."""
        fin = obs.finite_or_none
        rec = {"iter": it, "conv": fin(self.conv), "seconds": seconds,
               "best_outer": fin(self.best_bound)}
        if self._shard_ops is not None:
            rec["sharding"] = {
                "mode": "sharded",
                "n_devices": self._shard_ops.n_devices,
                "shard_scenarios": self._shard_ops.shard_size}
        if self.spcomm is not None:
            outer = fin(getattr(self.spcomm, "BestOuterBound", None))
            inner = fin(getattr(self.spcomm, "BestInnerBound", None))
            rec["best_outer"] = outer if outer is not None \
                else rec["best_outer"]
            rec["best_inner"] = inner
            if outer is not None and inner is not None and inner != 0:
                rec["gap_rel"] = (inner - outer) / abs(inner)
        res = self.residual_summary(True)
        if res is not None:
            rec.update(res)
        if self._shrink_status is not None:
            rec["shrink"] = dict(self._shrink_status)
        if self._stream_source is not None:
            rec["stream"] = self._stream_source.status()
        aph = getattr(self, "_aph_status", None)
        if aph:
            rec["aph"] = dict(aph)
        now = self._phase_totals()
        rec["phase_seconds"] = {k: now[k] - phase_before.get(k, 0.0)
                                for k in now}
        ctr = obs.counters_snapshot()
        rec["counter_deltas"] = {
            k: ctr.get(k, 0) - counters_before.get(k, 0)
            for k in self._ITER_DELTA_COUNTERS
            if ctr.get(k, 0) != counters_before.get(k, 0)}
        deltas = rec["counter_deltas"]
        from ..obs import profile as _obs_profile
        fig = _obs_profile.note_iteration(
            it, seconds, deltas.get("profile.flops", 0),
            deltas.get("profile.hbm_bytes", 0))
        if fig is not None:
            rec["profile"] = fig
        if self._forensics_every > 0 \
                and it % self._forensics_every == 0:
            fx = self._forensic_sample(it)
            if fx is not None:
                rec["forensics"] = fx
        return rec

    def iter0_feasible_mask(self, tol=None):
        """(ok_per_scenario, tol): a scenario passes on EITHER the
        absolute or the relative primal residual of its iter-0 solve."""
        if tol is None:
            tol = float(self.options.get("iter0_feas_tol",
                                         max(1e-3, 100 * self.sub_eps)))
        st = self._qp_states[False]
        pri, rel = self._real_rows(st.pri_res, st.pri_rel)
        return (pri <= tol) | (rel <= tol), tol

    def _real_rows(self, *vecs):
        """Host copies of per-scenario (S,) vectors, every rank's rows
        on a sharded mesh (one all-reduce), zero-probability pad rows
        trimmed."""
        out = []
        for v in vecs:
            if self._shard_ops is not None:
                v = self.gather_rows(v)
            out.append(to_host(v)[:self._S_orig])
        return out

    def assert_feasible_iter0(self, tol=None):
        """Abort when any scenario's iter-0 subproblem came out
        infeasible (ref. phbase.py:1415-1427); gated by the
        ``iter0_infeasibility_abort`` option (default on)."""
        if not self.options.get("iter0_infeasibility_abort", True):
            return
        ok, tol = self.iter0_feasible_mask(tol)
        if not np.all(ok):
            bad = np.flatnonzero(~ok)
            names = [self.global_batch.tree.scen_names[i]
                     for i in bad[:5]]
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
                self._refuse_streamed("the recourse-integer dive")
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
                if not self._all_ranks(feasible.all()):
                    return None
                return float(self.Eobjective(obj))
            self.solve_loop(w_on=False, prox_on=False, update=False,
                            fixed=True)
            st = self._qp_states[("fixed", False)]
            pri = to_host(st.pri_res)
            rel = to_host(st.pri_rel)
            if not self._all_ranks(np.all((pri <= feas_tol)
                                          | (rel <= feas_tol))):
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
        columns), so chunking is exact. On a sharded mesh each rank
        dives its own rows with the solver's stopping rules local to
        them (its rounds decide on the host from its own rows), so no
        collective runs inside."""
        with mesh_scope(None):
            return self._dive_local(factors, d, q, c0, st, imask, **kw)

    def _dive_local(self, factors, d, q, c0, st, imask, **kw):
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
        self._refuse_streamed("dive_nonant_candidates")
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
        sh = self._shard_ops
        if X is not None and sh is not None \
                and np.shape(X)[0] == sh.S:
            # the whole (S_pad, K) consensus: this rank's rows
            X = np.asarray(X)[sh.lo:sh.hi]
        if not imask.any():
            xn = self._hub_nonants() if X is None else X
            if sh is not None:
                xn = self.gather_rows(torch.as_tensor(
                    np.asarray(X), dtype=self.dtype, device=self.device)
                    if X is not None else xn)
            return to_host(xn), np.ones(xn.shape[0], bool)
        prox_on = X is not None
        factors, d = self._get_factors(prox_on, full=True)
        if prox_on:
            Xt = torch.as_tensor(np.array(X, dtype=np.float64),
                                 dtype=self.dtype, device=self.device)
            q = self.c.index_add(1, self.nonant_idx, -self.rho * Xt)
        else:
            q = self.c
        if self._shrink is None:
            st = self._ensure_state(prox_on)
        else:
            # the cached hot-loop state is compacted: dive from a
            # full-width cold state instead of clobbering it
            st = qp_cold_state(factors, d)
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
        xn = x[:, self.nonant_idx]
        if sh is not None:
            # every rank's candidates (the padded whole, as the JAX
            # package's sharded engine returns them)
            xn = self.gather_rows(xn)
            feasible = self.gather_rows(feasible.to(torch.uint8)).bool()
        return to_host(xn), to_host(feasible)

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
        self._refuse_streamed("evaluate_incumbent_pool")
        if self._shard_ops is not None:
            raise _not_ported("the batched incumbent-pool evaluation on a "
                              "sharded engine", "A8b")
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
        pt0 = ctr0 = None
        for it in range(1, self.max_iterations + 1):
            self._iter = it
            rec_on = obs.enabled()
            if rec_on and ctr0 is None:
                # the record's windows: phase wall-clock totals and the
                # counters, diffed after the solve. Later windows open
                # at the previous record's close, so counters booked by
                # miditer extensions land in the next iteration's deltas
                pt0 = self._phase_totals()
                ctr0 = obs.counters_snapshot()
            t_it = _time.perf_counter()
            self.solve_loop(w_on=True, prox_on=True)
            self.W = self.W_new
            if rec_on:
                t_end = _time.perf_counter()
                obs.complete_span("ph.iteration", t_it, t_end, cat="ph",
                                  args={"iter": it})
                obs.histogram_observe("ph.iteration_seconds", t_end - t_it)
                obs.event("ph.iteration", self.iteration_record(
                    it, t_end - t_it, pt0, ctr0))
                pt0 = self._phase_totals()
                ctr0 = obs.counters_snapshot()
                # device memory watermark gauges (a no-op on the CPU)
                _obs_resource.sample_memory()
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
