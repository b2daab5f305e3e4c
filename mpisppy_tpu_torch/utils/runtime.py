"""Device choice and precision pins for the port.

The port runs on the CUDA device. ``resolve_device`` never falls back
to the CPU silently: without a card, the caller has to ask for
``device="cpu"`` (the CPU tests do).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# the port's engine dtype: the solver's certified bounds need f64, and
# the H100 executes f64 natively
DTYPE = torch.float64


def pin_precision() -> None:
    """Full-precision matmuls: no TF32 in float32 products or
    convolutions (PyTorch enables TF32 for cuDNN by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_LINALG_READY = set()
_LINALG_LOCK = threading.Lock()


def _init_cuda_linalg(dev: torch.device) -> None:
    """Load torch's CUDA linear-algebra backend once, from the thread
    that builds the engine. Its lazy loader is not safe to enter from
    two threads at once ("lazy wrapper should be called at most once"),
    and the wheel's cylinder threads each factorize on their first
    solve."""
    with _LINALG_LOCK:
        if dev in _LINALG_READY:
            return
        eye = torch.eye(2, dtype=torch.float64, device=dev)
        L = torch.linalg.cholesky(eye)
        torch.linalg.solve_triangular(L, eye, upper=False)
        torch.linalg.inv(eye)
        torch.cuda.synchronize(dev)
        _LINALG_READY.add(dev)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raise when there is none. An
    explicit ``"cpu"`` (or any other device) is taken as given. A CUDA
    device gets its linear-algebra backend loaded here."""
    pin_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpisppy_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        _init_cuda_linalg(dev)
    return dev


def to_host(a, dtype=None) -> np.ndarray:
    """Host numpy copy of a tensor on any device (``np.asarray`` of a
    CUDA tensor raises), or of any array-like: the one way cylinder
    code reads engine state."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


_DISTRIBUTED_UP = False


def maybe_init_distributed(coordinator) -> bool:
    """Join a multi-process run behind the ``RunConfig.coordinator``
    knob (the JAX package's utils/runtime.py:38): with ``coordinator``
    set, start the ``torch.distributed`` process group so
    ``parallel/mesh.make_mesh()`` builds the mesh over every rank of
    the run. Idempotent; returns True once the group is up (now or
    earlier), False without a coordinator.

    ``coordinator`` keeps the JAX package's keys: ``address``
    ("host:port" of process 0, required), ``num_processes``,
    ``process_id``, optional ``local_device_ids``. The mapping: a JAX
    process is a host driving all of its devices; a port process is ONE
    rank driving one card. ``num_processes`` is the world size (every
    rank of every host), ``process_id`` this rank, and
    ``local_device_ids`` the cards of this host the host's ranks use,
    in local-rank order (this rank takes entry ``process_id % len``).
    The backend follows parallel/launch.choose_backend: NCCL when each
    rank has its own card, gloo otherwise."""
    global _DISTRIBUTED_UP
    if not coordinator:
        return False
    import torch.distributed as dist
    if _DISTRIBUTED_UP or dist.is_initialized():
        _DISTRIBUTED_UP = True
        return True
    import os

    from ..parallel.launch import choose_backend
    world = int(coordinator.get("num_processes") or 1)
    rank = int(coordinator.get("process_id") or 0)
    ids = coordinator.get("local_device_ids")
    if ids:
        local = int(ids[rank % len(ids)])
        os.environ["LOCAL_RANK"] = str(local)
        backend = "nccl" if torch.cuda.is_available() \
            and len(set(ids)) == len(ids) else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local)
    else:
        backend = choose_backend(world)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator['address']}",
                            rank=rank, world_size=world)
    _DISTRIBUTED_UP = True
    return True
