"""Build and load the port's hand-written Hopper kernels.

``csrc/spmv_kernels.cu`` (beside this package's modules) has a plain C
interface: nvcc compiles it for ``sm_90a`` into a shared library, and
ctypes loads it. Nothing here runs at import time — the first call to
:func:`lib` builds (or reuses) the library — so every module of the port
imports on a machine without CUDA.

The library is content-addressed: ``build/kernels/spmv_kernels-<hash>.so``
at the repository root, where the hash covers the source and the nvcc
command, so an edited kernel never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["lib", "check", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "spmv_kernels.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

#: route (b) of the Hopper build: plain C ABI, no PyTorch headers
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, and no $CUDA_HOME/bin/nvcc): "
            "cannot build the CUDA kernels"
        )
    return path


def _build() -> str:
    """Compile the kernel source unless a build of it exists; return the
    library path. Raises with nvcc's stderr when the build fails."""
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(_BUILD_DIR, f"spmv_kernels-{tag[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}): {' '.join(cmd)}\n"
            f"{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(path: str) -> ctypes.CDLL:
    cdll = ctypes.CDLL(path)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    cdll.cfs_sdia_sym.argtypes = [p, p, i32, i64, p, i64, p, i64, p]
    cdll.cfs_sdia_sym.restype = i32
    cdll.cfs_sdia_gen.argtypes = [p, p, i32, i64, p, i64, p, p]
    cdll.cfs_sdia_gen.restype = i32
    cdll.cfs_sbell_spmv.argtypes = [p, p, p, p, i64, i32, i32, i32, p, p, p]
    cdll.cfs_sbell_spmv.restype = i32
    cdll.cfs_bell2_spmv.argtypes = [
        p, p, p, p, i64, i32, i32, i32, i32, p, p, p,
    ]
    cdll.cfs_bell2_spmv.restype = i32
    cdll.cfs_unperm_gather.argtypes = [p, p, i32, p, p, i64, p]
    cdll.cfs_unperm_gather.restype = i32
    cdll.cfs_cuda_error_string.argtypes = [i32]
    cdll.cfs_cuda_error_string.restype = ctypes.c_char_p
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(_build())
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a nonzero ``cudaGetLastError()``."""
    if err:
        msg = lib().cfs_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
