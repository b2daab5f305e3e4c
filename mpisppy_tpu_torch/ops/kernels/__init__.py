"""Kernel-backend layer for the ADMM subproblem solver (the port of
mpisppy_tpu/ops/kernels/__init__.py, native precision).

Modes (``subproblem_kernel_mode``): ``segmented`` runs the
host-segmented qp_solver driver; ``fused`` runs one solve call per
subproblem solve, with backend ``reference`` (qp_solve) or ``cuda``
(the hand-written ADMM block, ``admm_block``, then the qp_solve
finisher); ``auto`` resolves to fused. ``pallas`` is read as ``cuda``.

The ``mixed`` and ``df32`` precisions wait for their slice (A7b in
ROADMAP.md) and raise NotImplementedError here.
"""

from __future__ import annotations

from dataclasses import dataclass

from ... import obs
from ...utils.config import FUSED_IR_SWEEPS, canonical_backend
from ..qp_solver import _needs_host_factor, qp_solve
from . import admm_block

# The JAX package's WATCHDOG_F64_ITERS rule (auto refusing to fuse long
# f64 stretches) is a TPU runtime watchdog. CUDA has no such watchdog,
# so it does not apply here and auto never demotes for stretch length.


def _not_ported(precision):
    return NotImplementedError(
        f"subproblem_precision={precision!r} belongs to the df32/mixed "
        "slice, not ported yet (see ROADMAP.md)")


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
    # host copy of factors.sigma, read once here so no solve reads a
    # device scalar back
    sigma_host: float | None = None

    def descriptor(self) -> dict:
        return {"mode": self.mode, "backend": self.backend}


SEGMENTED_PLAN = KernelPlan(mode="segmented", backend="reference",
                            precision="native")


def prepare(factors, *, mode="auto", backend="reference",
            precision="native", ir_sweeps=1):
    """Resolve the kernel decisions for one mode's factors, once per
    factorization: the mode, the effective backend and the host copy of
    sigma. (The JAX package's L⁻¹, bf16 and budget arguments serve its
    df32/mixed branches, which are not ported.)"""
    if precision in ("mixed", "df32"):
        raise _not_ported(precision)
    if int(ir_sweeps) not in FUSED_IR_SWEEPS:
        if mode == "fused":
            raise ValueError(
                f"kernel mode 'fused' supports ir_sweeps in "
                f"[{FUSED_IR_SWEEPS.start}, {FUSED_IR_SWEEPS.stop - 1}]"
                f"; got {ir_sweeps} (use 'segmented')")
        return SEGMENTED_PLAN
    if resolve_mode(mode, factors) == "segmented":
        return SEGMENTED_PLAN
    eff = canonical_backend(backend)
    if eff == "cuda" and getattr(factors.A_s, "ndim", 0) != 2:
        # outside the block's scope (batched A): the reference backend
        eff = "reference"
    sig = getattr(factors, "sigma", None)
    return KernelPlan(mode="fused", backend=eff, precision=precision,
                      sigma_host=None if sig is None else float(sig))


def kernel_solve(plan: KernelPlan, factors, data, q, state, *,
                 precision, max_iter, tail_iter, e_pri, e_dua,
                 stall_rel, polish, polish_chunk, ir_sweeps,
                 check_every=25, polish_iters=12, adaptive_rho=True):
    """The fused-mode solve: same (state, x, yA, yB) contract as the
    segmented driver (``tail_iter`` and ``ir_sweeps`` are the df32 knobs
    of the JAX package's signature, unused in native precision). On the
    cuda backend the ADMM block runs the WHOLE budget at fixed rho, then
    qp_solve(max_iter=0) polishes and unscales its iterates through the
    reference code, and ``iters`` is set to the budget: a host int, as
    every solver state of the port carries it (the JAX package keeps a
    device int32 there), so the chunked loop books ``kernel.fused_iters``
    without a device read. The chunked loop's retries and hospital pass
    ``kernel=None`` and never reach this function: they run segmented
    in native precision."""
    if precision in ("mixed", "df32"):
        raise _not_ported(precision)
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
        x_s, yA_s, yB_s, zA_s, zB_s, _, _ = admm_block.fused_admm_block(
            factors, data, q, state, n_steps=max_iter,
            sigma=plan.sigma_host)
        st = state._replace(x=x_s, yA=yA_s, yB=yB_s, zA=zA_s, zB=zB_s)
        st, x, yA, yB = qp_solve(factors, data, q, st, max_iter=0,
                                 **solve_kw)
        return st._replace(iters=int(max_iter)), x, yA, yB
    return qp_solve(factors, data, q, state, max_iter=max_iter, **solve_kw)
