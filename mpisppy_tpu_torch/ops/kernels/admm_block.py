"""The fused ADMM iteration block: the port of
mpisppy_tpu/ops/kernels/pallas_kernel.py.

``fused_admm_block`` runs ``n_steps`` fixed-rho relaxed ADMM steps on
the scaled shared-structure QP and returns the scaled iterates plus the
unscaled residual maxima (pri, dua) per scenario. On CUDA tensors it
launches the hand-written Hopper kernel (``csrc/admm_block.cu``, built
by ``_build``); on CPU tensors it runs ``admm_block_plain``, the same
arithmetic in plain PyTorch. Nothing falls back: a CUDA call that
cannot build or launch raises.

Scope (``scope_supported``): a shared dense (m, n) A and an f64
explicit-inverse solve operator — the f64 M⁻¹ of the native-precision
factorization, or an ``LInv`` pair (x = L⁻ᵀ(L⁻¹ b), two products).

Scenario tiling: scenario rows are independent through the whole block
(A and F are shared; projections, dual updates and the residual maxima
are row-local), so the scenario axis may be cut into ``scen_tile``-row
tiles, each its own call; the kernel's per-row summation order does
not depend on the tile, so tiled and untiled results are bit-equal.

Tile schedule (``block_schedule``): how far the kernel splits each
product's reduction axis. It is computed here from the matrix shape
(m, n) alone, never from S, since the split fixes the order of
summation: a schedule that followed S would break the bit-equality of
tiled and untiled calls.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..qp_solver import LInv, _scaled_problem

__all__ = ["LAUNCHES", "SCEN_GROUP", "SCEN_TILE_TARGET",
           "admm_block_launches", "admm_block_plain", "block_schedule",
           "fused_admm_block", "launch_plan", "pick_scen_tile",
           "scope_supported", "thread_launches"]

# CUDA kernel launches made by fused_admm_block (admm_block_launches per
# call); the plain CPU path launches nothing and adds nothing. Cylinder
# threads launch concurrently: the global total is bumped under a lock,
# and each thread also keeps its own count (thread_launches), from
# which the kernel layer books launches per engine.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()
_TLS = threading.local()


def thread_launches() -> int:
    """Kernel launches made by the calling thread so far."""
    return getattr(_TLS, "count", 0)

# Tile geometry of csrc/admm_block.cu, which refuses a schedule planned
# for another: the col orientation (y = v·B) gives a CTA COL_TILE output
# columns and streams COL_STAGE matrix rows per ring stage; the row
# orientation (y = v·Bᵀ) ROW_TILE output rows and ROW_STAGE columns; the
# sum kernels take SUM_TILE elements per CTA.
COL_TILE, COL_STAGE = 256, 16
ROW_TILE, ROW_STAGE = 128, 32
SUM_TILE = 256
# the split targets an H100 SXM's 132 SMs (one product CTA each); a
# constant, not a device query, so the summation order is a function of
# the shape alone
SPLIT_SMS = 132
MAX_SPLIT = 32          # bounds the partial-sum scratch, P x S x L
MIN_PART_STAGES = 2
RAMP_STAGES = 2         # a CTA's ring fill, in stages of streaming time

# rows per scenario tile when the caller does not choose
SCEN_TILE_TARGET = 128
# scenario rows per group on the kernel's grid.y (csrc: SB_MAX): every
# group streams A and F through its own CTAs
SCEN_GROUP = 16

# operand order of the C entry point admm_block_run
_IN = ("A", "F", "Ps", "g", "q_s", "l_s", "u_s", "lb_s", "ub_s", "rA",
       "rB", "Einv", "Ebinv", "Dinv_c", "D")
_ITER = ("x", "yA", "yB", "zA", "zB")
# scratch and outputs after them
_SCRATCH = ("rhs", "xt", "ut", "w", "part", "pri", "dua", "part_rows",
            "part_cpri", "part_cdua")
# admm_block_run's code for a refused schedule (csrc: ERR_SCHEDULE)
_ERR_SCHEDULE = 100000
# scalings that may be shared (rank 1) or per scenario (rank 2), with
# the axis length they run over
_SCALINGS = (("Ps", "n"), ("g", "n"), ("rA", "m"), ("rB", "n"),
             ("Einv", "m"), ("Ebinv", "n"), ("Dinv_c", "n"), ("D", "n"))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _split(tiles: int, stages: int) -> tuple[int, int]:
    """(parts, stages per part) for a product of ``tiles`` output tiles
    whose reduction axis is ``stages`` ring stages long: the split with
    the least modelled time, waves of SPLIT_SMS CTAs x (stages per part
    + the ring fill); on a tie the fewer parts. Every part is non-empty
    and only the last may be shorter."""
    best = None
    for parts in range(1, min(MAX_SPLIT, max(1, stages // MIN_PART_STAGES))
                       + 1):
        per = _ceil(stages, parts)
        used = _ceil(stages, per)
        cost = _ceil(tiles * used, SPLIT_SMS) * (per + RAMP_STAGES)
        if best is None or cost < best[0]:
            best = (cost, used, per)
    return best[1], best[2]


def _stages(m: int, n: int) -> dict:
    """Per (matrix, orientation) product of A (m, n) and F (n, n):
    (output tiles, ring stages along the reduction axis). A_col serves
    K1 (w·A) and the dual tail (yA·A), F_col K2, F_row the first L⁻¹
    product (rhs·Fᵀ), A_row K3 (x̃·Aᵀ) and the primal tail (x·Aᵀ)."""
    col_tiles = _ceil(n, COL_TILE)
    return {"A_col": (col_tiles, _ceil(m, COL_STAGE)),
            "F_col": (col_tiles, _ceil(n, COL_STAGE)),
            "F_row": (_ceil(n, ROW_TILE), _ceil(n, ROW_STAGE)),
            "A_row": (_ceil(m, ROW_TILE), _ceil(n, ROW_STAGE))}


def block_schedule(m: int, n: int) -> dict:
    """The kernel's split of each (matrix, orientation) product, from
    the shape of A (m, n) alone: {"A_col", "F_col", "F_row", "A_row"}
    -> (parts, stages per part)."""
    return {key: _split(tiles, stages)
            for key, (tiles, stages) in _stages(m, n).items()}


def launch_plan(S: int, m: int, n: int, l_inv_pair: bool) -> dict:
    """What one kernel call needs for S scenario rows: the schedule
    (shape-only), the C entry point's ``sched`` ints and the scratch
    lengths in doubles."""
    sched = block_schedule(m, n)
    parts = [sched["A_col"][0] * n, sched["F_col"][0] * n,
             sched["A_row"][0] * m]
    if l_inv_pair:
        parts.append(sched["F_row"][0] * n)
    ints = [COL_TILE, COL_STAGE, ROW_TILE, ROW_STAGE, SUM_TILE]
    for key in ("A_col", "F_col", "F_row", "A_row"):
        ints += list(sched[key])
    return {"schedule": sched, "sched_ints": ints,
            "part": S * max(parts), "row_tiles": _ceil(m, SUM_TILE),
            "col_tiles": _ceil(n, SUM_TILE)}


def admm_block_launches(n_steps: int, l_inv_pair: bool) -> int:
    """Kernels one CUDA call launches: the w prologue; per step a split
    product and its sum kernel for K1, K2 and K3 (and LINV1 with an L⁻¹
    pair); the tail's two products with their sums and the finalize."""
    return 1 + int(n_steps) * (8 if l_inv_pair else 6) + 5


def pick_scen_tile(S: int, target: int = SCEN_TILE_TARGET) -> int:
    """Largest divisor of S that is <= target; S itself when S is at or
    under the target; 1-row tiles only for prime S."""
    S = int(S)
    if S <= target:
        return S
    for tile in range(target, 1, -1):
        if S % tile == 0:
            return tile
    return 1


def scope_supported(factors, state) -> bool:
    """Whether this solve's operands fit the block: shared dense f64 A
    with an f64 explicit-inverse solve operator (M⁻¹ or LInv)."""
    A_s = factors.A_s
    if not isinstance(A_s, torch.Tensor) or A_s.ndim != 2 \
            or A_s.dtype != torch.float64:
        return False
    L = state.L
    return L.ndim == 2 and L.dtype == torch.float64


def admm_block_plain(A, F, Ps, g, q_s, l_s, u_s, lb_s, ub_s, rA, rB,
                     Einv, Ebinv, Dinv_c, D, x, yA, yB, zA, zB, *, sigma,
                     n_steps, alpha=1.6, l_inv_pair=False):
    """The block in plain PyTorch: ``one()`` of pallas_kernel.py
    repeated ``n_steps`` times, then the residual tail. Returns
    (x, yA, yB, zA, zB, pri, dua)."""
    def m_solve(rhs):
        if l_inv_pair:
            return (rhs @ F.T) @ F
        return rhs @ F

    for _ in range(int(n_steps)):
        rhs = sigma * x - q_s + (rA * zA - yA) @ A + g * (rB * zB - yB)
        x_t = m_solve(rhs)
        x_new = alpha * x_t + (1 - alpha) * x
        zA_t = x_t @ A.T
        zA_mix = alpha * zA_t + (1 - alpha) * zA
        zA_new = torch.clamp(zA_mix + yA / rA, l_s, u_s)
        yA = yA + rA * (zA_mix - zA_new)
        zB_t = g * x_t
        zB_mix = alpha * zB_t + (1 - alpha) * zB
        zB_new = torch.clamp(zB_mix + yB / rB, lb_s, ub_s)
        yB = yB + rB * (zB_mix - zB_new)
        x, zA, zB = x_new, zA_new, zB_new
    Ax = x @ A.T
    Aty = yA @ A
    pri = torch.maximum((Einv * (Ax - zA)).abs().amax(dim=1),
                        (D * x - Ebinv * zB).abs().amax(dim=1))
    dua = (Dinv_c * (Ps * x + q_s + Aty + g * yB)).abs().amax(dim=1)
    return x, yA, yB, zA, zB, pri, dua


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"admm_block: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"admm_block: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float64:
        raise TypeError(f"admm_block: {name} has dtype {t.dtype}; the "
                        "kernel takes float64")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"admm_block: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"admm_block: {name} is not contiguous")


def _launch(ops, sigma, n_steps, alpha, l_inv_pair):
    """Run the CUDA block on one scenario tile. ``ops`` maps the names
    of _IN + _ITER to CUDA tensors; iterates are copied into fresh
    outputs that the kernel updates in place."""
    global LAUNCHES
    from . import _build

    lib = _build.load("admm_block")
    S, n = ops["x"].shape
    m = ops["zA"].shape[1]
    dev = ops["x"].device
    dims = {"m": m, "n": n}
    _check("A", ops["A"], (m, n), dev)
    _check("F", ops["F"], (n, n), dev)
    strides = []
    for name, axis in _SCALINGS:
        t = ops[name]
        shape = (dims[axis],) if t.ndim == 1 else (S, dims[axis])
        _check(name, t, shape, dev)
        strides.append(0 if t.ndim == 1 else dims[axis])
    for name in ("q_s", "lb_s", "ub_s", "x", "yB", "zB"):
        _check(name, ops[name], (S, n), dev)
    for name in ("l_s", "u_s", "yA", "zA"):
        _check(name, ops[name], (S, m), dev)

    out = {k: ops[k].clone() for k in _ITER}
    plan = launch_plan(S, m, n, l_inv_pair)
    kw = dict(dtype=torch.float64, device=dev)
    scratch = {"rhs": torch.empty((S, n), **kw),
               "xt": torch.empty((S, n), **kw),
               "ut": torch.empty((S, n) if l_inv_pair else (1,), **kw),
               "w": torch.empty((S, m), **kw),
               "part": torch.empty((plan["part"],), **kw),
               "pri": torch.empty((S,), **kw),
               "dua": torch.empty((S,), **kw),
               "part_rows": torch.empty((S, plan["row_tiles"]), **kw),
               "part_cpri": torch.empty((S, plan["col_tiles"]), **kw),
               "part_cdua": torch.empty((S, plan["col_tiles"]), **kw)}
    ptr_list = [ops[k].data_ptr() for k in _IN] \
        + [out[k].data_ptr() for k in _ITER] \
        + [scratch[k].data_ptr() for k in _SCRATCH]
    ptrs = (ctypes.c_uint64 * len(ptr_list))(*ptr_list)
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_dims = (ctypes.c_int * 3)(S, m, n)
    c_scal = (ctypes.c_double * 2)(float(sigma), float(alpha))
    c_sched = (ctypes.c_int * len(plan["sched_ints"]))(*plan["sched_ints"])
    launches = ctypes.c_int(0)
    fn = lib.admm_block_run
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ptrs, c_strides, c_dims, c_scal, c_sched, int(n_steps),
             int(bool(l_inv_pair)), ctypes.c_void_p(stream),
             ctypes.byref(launches))
    with _LAUNCH_LOCK:
        LAUNCHES += launches.value
    _TLS.count = thread_launches() + launches.value
    if err == _ERR_SCHEDULE:
        raise RuntimeError("admm_block: the kernel refused the tile "
                           f"schedule {plan['sched_ints']} for m={m}, "
                           f"n={n}")
    if err != 0:
        raise RuntimeError(f"admm_block kernel launch failed: CUDA error "
                           f"{err}")
    return (out["x"], out["yA"], out["yB"], out["zA"], out["zB"],
            scratch["pri"], scratch["dua"])


def _block(ops, sigma, n_steps, alpha, l_inv_pair):
    """One scenario tile: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if ops["x"].is_cuda:
        return _launch(ops, sigma, n_steps, alpha, l_inv_pair)
    if ops["x"].device.type != "cpu":
        raise ValueError(f"admm_block: no kernel for device "
                         f"{ops['x'].device}")
    return admm_block_plain(*(ops[k] for k in _IN + _ITER), sigma=sigma,
                            n_steps=n_steps, alpha=alpha,
                            l_inv_pair=l_inv_pair)


def fused_admm_block(factors, data, q, state, n_steps, sigma=None,
                     scen_tile=None):
    """Run ``n_steps`` fused ADMM steps on the scaled problem (factors,
    data, q) from ``state``; returns (x, yA, yB, zA, zB, pri, dua) —
    SCALED iterates plus the unscaled residual maxima. Scaling comes
    from qp_solver._scaled_problem, so the block iterates the exact
    problem _solve_impl would.

    ``sigma``: host float of ``factors.sigma`` (the kernel layer passes
    the plan's copy). ``scen_tile``: rows per scenario tile (None =
    pick_scen_tile, 0 = untiled)."""
    if sigma is None:
        sigma = float(factors.sigma)
    g, l_s, u_s, lb_s, ub_s, csx, q_s = _scaled_problem(factors, data, q)
    rs = state.rho_scale
    L = state.L
    l_inv_pair = isinstance(L, LInv)
    ops = {"A": factors.A_s, "F": L.inv if l_inv_pair else L,
           "Ps": factors.P_s, "g": g, "q_s": q_s, "l_s": l_s, "u_s": u_s,
           "lb_s": lb_s, "ub_s": ub_s, "rA": factors.rho_A * rs,
           "rB": factors.rho_b * rs, "Einv": 1.0 / factors.E,
           "Ebinv": 1.0 / factors.Eb, "Dinv_c": 1.0 / (factors.D * csx),
           "D": factors.D, "x": state.x, "yA": state.yA, "yB": state.yB,
           "zA": state.zA, "zB": state.zB}
    S = state.x.shape[0]
    if scen_tile is None:
        scen_tile = pick_scen_tile(S)
    scen_tile = int(scen_tile)
    if not scen_tile or scen_tile >= S:
        return _block(ops, sigma, n_steps, 1.6, l_inv_pair)
    if S % scen_tile:
        raise ValueError(f"scen_tile {scen_tile} must divide the scenario "
                         f"rows {S}")
    per_scen = set(_ITER) | {"q_s", "l_s", "u_s", "lb_s", "ub_s"}
    parts = []
    for lo in range(0, S, scen_tile):
        sl = slice(lo, lo + scen_tile)
        tile = {k: (v[sl] if (k in per_scen or (k in dict(_SCALINGS)
                                                and v.ndim == 2)) else v)
                for k, v in ops.items()}
        parts.append(_block(tile, sigma, n_steps, 1.6, l_inv_pair))
    return tuple(torch.cat(p) for p in zip(*parts))
