"""Kernel option constants of the engine (the subset of
mpisppy_tpu/utils/config.py the port's PH engine validates)."""

KERNEL_MODES = ("auto", "fused", "segmented")
# "cuda" is the hand-written Hopper ADMM block (ops/kernels/admm_block);
# "pallas" is accepted as an alias of "cuda" so the JAX package's option
# dicts run unchanged against the port
KERNEL_BACKENDS = ("reference", "cuda", "pallas")
KERNEL_BACKEND_ALIASES = {"pallas": "cuda"}
# the df32 tail's L⁻¹ trade (ops/kernels/reference.l_inv_profitable)
# and the bulk phase's packed-block storage: the JAX package's values,
# of which the port runs f32 only ("bf16" raises, ROADMAP.md)
KERNEL_L_INV_MODES = ("auto", "on", "off")
KERNEL_BLOCK_DTYPES = ("auto", "bf16", "f32")
FUSED_IR_SWEEPS = range(1, 5)


def canonical_backend(name: str) -> str:
    """The backend a (possibly aliased) option value selects."""
    return KERNEL_BACKEND_ALIASES.get(name, name)
