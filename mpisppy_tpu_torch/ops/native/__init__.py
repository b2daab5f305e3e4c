"""Build and ctypes binding of the native shared-memory windows
(``spwindow.cpp``: the cylinder window protocol over POSIX shared memory
with a seqlock, for cylinders and scenario shards run as processes).

At first use the host C++ compiler builds ``spwindow.cpp`` from this
package into ``<repo>/build/native``; the file name carries a hash of
the source and flags, so an edited source is never served from a stale
build. The spawned processes of a wheel load it at the same moment, so
the build runs under a file lock in that directory and is renamed into
place. A missing compiler or a failed build raises: nothing falls back
to in-process windows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

from ..kernels._build import file_lock

SRC = Path(__file__).resolve().parent / "spwindow.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
# shm_open/shm_unlink live in librt on glibc before 2.34 (harmless
# after); macOS keeps them in libc and has no librt
LIBS = ["-lrt"] if sys.platform.startswith("linux") else []

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found: the shared-memory windows "
                       "are built from source at first use")


def target() -> Path:
    """The shared library built from the current source."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS + LIBS).encode()
                            ).hexdigest()
    return BUILD_DIR / f"libspwindow-{digest[:12]}.so"


def build() -> Path:
    """Compile ``spwindow.cpp`` unless a current build exists. Returns
    the library's path; raises when the compiler fails."""
    lib = target()
    with file_lock(BUILD_DIR / ".lock"):
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SRC.name} failed "
                               f"({' '.join(cmd)}):\n{out.stderr}")
        os.replace(tmp, lib)
    return lib


def load():
    """Build (if needed) and load the spwindow library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.spw_create.restype = ctypes.c_void_p
        lib.spw_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.spw_open.restype = ctypes.c_void_p
        lib.spw_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.spw_put.restype = None
        lib.spw_put.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int64]
        lib.spw_read.restype = ctypes.c_int64
        lib.spw_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int64]
        lib.spw_read_id.restype = ctypes.c_int64
        lib.spw_read_id.argtypes = [ctypes.c_void_p]
        lib.spw_kill.restype = None
        lib.spw_kill.argtypes = [ctypes.c_void_p]
        lib.spw_close.restype = None
        lib.spw_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib
