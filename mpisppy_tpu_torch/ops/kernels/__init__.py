"""Kernel-backend layer for the ADMM subproblem solver (the port of
mpisppy_tpu/ops/kernels/__init__.py).

Modes (``subproblem_kernel_mode``): ``segmented`` runs the
host-segmented qp_solver drivers; ``fused`` runs one solve call per
subproblem solve, with backend ``reference`` (qp_solve) or ``cuda``
(the hand-written ADMM block, ``admm_block``, then the qp_solve
finisher); ``auto`` resolves to fused. ``pallas`` is read as ``cuda``.

The ``mixed`` and ``df32`` precisions run fused through
``reference.fused_mixed_solve`` (f32 bulk, factor handoff, accurate
tail in one call). As in the JAX package they never enter the ADMM
block: its scope is native precision on a plain 2-D A. Their L⁻¹
trade (the tail's triangular solves as products) and the bulk's f32 A
operand are resolved once per factorization by ``prepare``.

Counter: ``kernel.l_inv_factorizations`` (eager L⁻¹ builds).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...utils.config import FUSED_IR_SWEEPS, canonical_backend
from ... import obs
from ..qp_solver import (SplitMatrix, _needs_host_factor, bulk_operand,
                         qp_solve)
from . import admm_block
from .reference import fused_mixed_solve, l_inv_profitable

# The JAX package's WATCHDOG_F64_ITERS rule (auto refusing to fuse long
# f64 stretches) is a TPU runtime watchdog. CUDA has no such watchdog,
# so it does not apply here and auto never demotes for stretch length.


def resolve_mode(mode: str, factors) -> str:
    """``auto`` resolution: fused unless the factors' rho adaptation
    would have to refactorize on the host (never on the port's
    devices)."""
    if mode in ("segmented", "fused"):
        return mode
    return "segmented" if _needs_host_factor(factors) else "fused"


@dataclass
class KernelPlan:
    """One mode's resolved kernel decisions, prepared once per
    factorization (core/ph caches plans beside the factor cache)."""
    mode: str                    # "fused" | "segmented"
    backend: str                 # "reference" | "cuda" (effective)
    precision: str
    l_inv: bool = False
    A_lo: object = None          # bulk-phase A_s operand (mixed/df32)
    # host copy of factors.sigma, read once here so no solve reads a
    # device scalar back
    sigma_host: float | None = None
    # ADMM block launches made through this plan (plans are per engine
    # and mode, so this books launches per engine)
    launches: int = 0

    def descriptor(self) -> dict:
        return {"mode": self.mode, "backend": self.backend,
                "l_inv": bool(self.l_inv),
                # the bulk's packed-block storage (the JAX package's
                # descriptor key; the port runs f32 blocks only)
                "block_dtype": "f32"}


SEGMENTED_PLAN = KernelPlan(mode="segmented", backend="reference",
                            precision="native")


def prepare(factors, *, mode="auto", backend="reference", l_inv="auto",
            precision="native", tail_iter=0, ir_sweeps=1, s_chunk=1):
    """Resolve the kernel decisions for one mode's factors, once per
    factorization: the mode, the effective backend, the host copy of
    sigma and, for mixed/df32, the L⁻¹ verdict (split factors only;
    ``l_inv_profitable`` over the tail budget and ``s_chunk`` rows per
    call under ``auto``) and the bulk phase's A operand."""
    if int(ir_sweeps) not in FUSED_IR_SWEEPS:
        if mode == "fused":
            raise ValueError(
                f"kernel mode 'fused' supports ir_sweeps in "
                f"[{FUSED_IR_SWEEPS.start}, {FUSED_IR_SWEEPS.stop - 1}]"
                f"; got {ir_sweeps} (use 'segmented')")
        return SEGMENTED_PLAN
    if resolve_mode(mode, factors) == "segmented":
        return SEGMENTED_PLAN
    split = isinstance(factors.A_s, SplitMatrix)
    use_linv = split and (l_inv == "on" or (
        l_inv == "auto" and l_inv_profitable(
            factors.A_s.shape[-1], s_chunk, tail_iter, ir_sweeps)))
    A_lo = bulk_operand(factors.A_s) if precision in ("mixed", "df32") \
        else None
    eff = canonical_backend(backend)
    if eff == "cuda" and (precision != "native" or split
                          or getattr(factors.A_s, "ndim", 0) != 2):
        # outside the block's scope (mixed/df32, a split or a batched
        # A): the reference backend, as in the JAX package
        eff = "reference"
    sig = getattr(factors, "sigma", None)
    return KernelPlan(mode="fused", backend=eff, precision=precision,
                      l_inv=use_linv, A_lo=A_lo,
                      sigma_host=None if sig is None else float(sig))


def kernel_solve(plan: KernelPlan, factors, data, q, state, *,
                 precision, max_iter, tail_iter, e_pri, e_dua,
                 stall_rel, polish, polish_chunk, ir_sweeps,
                 check_every=25, polish_iters=12, adaptive_rho=True):
    """The fused-mode solve: same (state, x, yA, yB) contract as the
    segmented drivers. Mixed/df32 run fused_mixed_solve (``max_iter``
    bounds the bulk, ``tail_iter`` the tail). In native precision on the
    cuda backend the ADMM block runs the WHOLE budget at fixed rho, then
    qp_solve(max_iter=0) polishes and unscales its iterates through the
    reference code, and ``iters`` is set to the budget: a host int, as
    every solver state of the port carries it (the JAX package keeps a
    device int32 there), so the chunked loop books ``kernel.fused_iters``
    without a device read. The chunked loop's retries and hospital pass
    ``kernel=None`` and never reach this function: they run segmented
    in native precision."""
    if precision in ("mixed", "df32"):
        return fused_mixed_solve(
            factors, plan.A_lo, data, q, state, bulk_iter=max_iter,
            tail_iter=tail_iter, check_every=check_every, eps_abs=e_pri,
            eps_rel=e_pri, eps_abs_dua=e_dua, eps_rel_dua=e_dua,
            polish=polish, polish_iters=polish_iters,
            polish_chunk=polish_chunk, stall_rel=stall_rel,
            ir_sweeps=ir_sweeps, l_inv=plan.l_inv,
            adaptive_rho=adaptive_rho)
    if plan.backend == "cuda" \
            and not admm_block.scope_supported(factors, state):
        # the state-dependent half of the scope check (an f32 Cholesky
        # factor, say): demote the cached plan so reports name the
        # backend that runs
        plan.backend = "reference"
        obs.event("kernel.cuda_demotion",
                  {"reason": "solve operator not an f64 explicit inverse"})
    solve_kw = dict(check_every=check_every, eps_abs=e_pri, eps_rel=e_pri,
                    polish=polish, polish_iters=polish_iters,
                    polish_chunk=polish_chunk, eps_abs_dua=e_dua,
                    eps_rel_dua=e_dua, stall_rel=stall_rel,
                    adaptive_rho=adaptive_rho)
    if plan.backend == "cuda":
        n0 = admm_block.thread_launches()
        x_s, yA_s, yB_s, zA_s, zB_s, _, _ = admm_block.fused_admm_block(
            factors, data, q, state, n_steps=max_iter,
            sigma=plan.sigma_host)
        plan.launches += admm_block.thread_launches() - n0
        st = state._replace(x=x_s, yA=yA_s, yB=yB_s, zA=zA_s, zB=zB_s)
        st, x, yA, yB = qp_solve(factors, data, q, st, max_iter=0,
                                 **solve_kw)
        return st._replace(iters=int(max_iter)), x, yA, yB
    return qp_solve(factors, data, q, state, max_iter=max_iter, **solve_kw)


def est_hbm_bytes_per_iter(*, n, m, s_chunk, pk_pass_bytes=None,
                           ir_sweeps=1, factor_bytes=4, vec_bytes=8):
    """The JAX package's traffic model of ONE fused df32 iteration per
    chunk, the byte model the chip check sets measured times against:

      tail  factor applies: 2 triangle passes x (1 seed + ir_sweeps IR
            solves) x n² x 4 B (the same bytes for triangular solves and
            L⁻¹ products: the trade converts latency, not traffic, so
            the model takes no L⁻¹ flag);
            A passes: (2 + 2·ir_sweeps) packed split passes over the
            hi+lo packed bytes (dense m·n·8 when unpacked);
            vectors: ~6 (S, m)/(S, n) f64 sweeps;
      bulk  one factor (2 triangle passes), two hi-only A passes (half
            the split bytes), f32 vectors.

    Returns {"tail": bytes, "bulk": bytes}."""
    a_pass = pk_pass_bytes if pk_pass_bytes is not None else m * n * 8
    tail_factor = 2 * (1 + int(ir_sweeps)) * n * n * factor_bytes
    tail_a = (2 + 2 * int(ir_sweeps)) * a_pass
    tail_vec = 6 * (m + n) * s_chunk * vec_bytes
    bulk_a_pass = a_pass / 2  # hi only, no lo operand in the bulk
    bulk = int(2 * n * n * factor_bytes + 2 * bulk_a_pass
               + 6 * (m + n) * s_chunk * 4)
    return {"tail": int(tail_factor + tail_a + tail_vec), "bulk": bulk}
