"""Build and load the hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, one ``nvcc``
per source, all started together, into ``<repo>/build/kernels`` (the
file name carries a hash of the source, so an edited kernel is never
served from a stale build). Libraries are loaded with ``ctypes``. A
missing ``nvcc`` or a failed build raises: nothing falls back.
Cylinder threads may reach their first launch together, so building
and loading run under one thread lock; the processes of a process
wheel may too, so the build also runs under a file lock in the build
directory (``file_lock``), and each build is renamed into place.
Each build that runs is booked as a ``kernel.build`` telemetry event
and counted in ``BUILDS``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ... import obs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()
# per-source build record: {"seconds": float, "log": str (ptxas report)}
BUILD_INFO: dict = {}
# nvcc builds run by this process (each one a ``kernel.build`` event):
# the serving layer's warm-bucket check reads its delta
BUILDS = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use and need the CUDA "
                           "toolkit")
    return path


@contextlib.contextmanager
def file_lock(path: Path):
    """An exclusive ``flock`` on ``path`` (created if missing) for the
    body: builds racing from several processes wait for the first one.
    The kernel drops the lock when its holder dies, so a killed build
    leaves no stale lock behind."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def build_all() -> dict:
    """Compile every source that has no current build, in parallel.
    Returns {stem: path of the shared library}."""
    with file_lock(BUILD_DIR / ".lock"):
        return _build_all_locked()


def _build_all_locked() -> dict:
    out, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        lib = _target(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    for src, lib, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO[src.stem] = {"seconds": time.perf_counter() - t0,
                                "log": log}
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, lib)
        global BUILDS
        BUILDS += 1
        # the port's one compile of a run (no jit): a telemetry event,
        # outside analyze's compile ledger
        obs.event("kernel.build", {"source": src.name,
                                   "seconds": BUILD_INFO[src.stem]["seconds"]})
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
        return lib
