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

import torch

from ..utils import trace

__all__ = ["lib", "check", "check_dtype", "check_values", "check_planes",
           "launch_groups", "count", "entry", "xy_dtype", "NVCC_FLAGS",
           "RHS_GROUP"]

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
    trace.count("kernels.builds")
    with trace.span("cfs.kernels.build", log=True):
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
    # every stream entry point ends in (x, xs, y, ys, nr, stream): a group
    # of nr planes at plane strides xs / ys, in elements
    planes = [p, i64, p, i64, i32, p]
    # the float, double and bf16 forms of an entry point differ in what
    # their pointers point at, not in their argument lists
    # (sdia_sym: the i32 before the planes stages x over planes)
    for fn in _forms(cdll, "sdia_sym"):
        fn.argtypes = [p, p, i32, i64, i64, i64, i32, *planes]
    # sdia_gen: (..., nv_rows, y_len, x_len, slices, store, hi, span,
    # planes); hi and span stage x in double (span -1: not staged)
    for fn in _forms(cdll, "sdia_gen"):
        fn.argtypes = [p, p, i32, i64, i64, i64, i32, i32, i32, i32, *planes]
    # sdia_sym_rows: (vals, offsets, D, n_vals_rows, n, ld, planes): X and Y
    # row-major at row stride ld, the planes' pointers at a group's first
    # column
    cdll.cfs_sdia_sym_rows_f64.argtypes = [p, p, i32, i64, i64, i64, *planes]
    # (nr, slices, staged) and (TW, nr, double): a CTA's shared memory
    cdll.cfs_sdia_gen_smem_f64.argtypes = [i32, i32, i32]
    cdll.cfs_sbell_smem.argtypes = [i32, i32, i32]
    for fn in _forms(cdll, "sbell_spmv"):
        fn.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, *planes]
    # (C, TW, nr, double)
    cdll.cfs_sbell_chunks_per_cta.argtypes = [i64, i32, i32, i32]
    # ... the i64 before the planes: the tile count of the planes to zero
    # whole (0: the visited blocks only); the float and bf16 ones read a
    # group of planes interleaved (``bell2_kernel.interleave_x``)
    for fn in _forms(cdll, "bell2_spmv"):
        fn.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, *planes]
    for fn in _forms(cdll, "bell2_entries"):
        fn.argtypes = [p, p, p, i64, *planes]
    # bell2_entries_rows: (ptr, cols, vals, tiles, nb, diag, x, y,
    # carry_row, carry_val, n, items, stream)
    cdll.cfs_bell2_entries_rows.argtypes = [p, p, p, p, i64, p, p, p, p, p,
                                            i64, i32, p]
    # unperm_gather: (pk, rows, W, g, gs, out, os, n_gather, n_out, diag, x,
    # x_row, x_col, n_seed, mode, B, stream)
    cdll.cfs_unperm_gather.argtypes = [p, p, i32, p, i64, p, i64, i64, i64,
                                       p, p, i64, i64, i64, i32, i32, p]
    for fn in (*(f for name in _FORMS for f in _forms(cdll, name)),
               cdll.cfs_sbell_chunks_per_cta, cdll.cfs_unperm_gather,
               cdll.cfs_sdia_gen_smem_f64, cdll.cfs_sbell_smem,
               cdll.cfs_sdia_sym_rows_f64, cdll.cfs_bell2_entries_rows):
        fn.restype = i32
    cdll.cfs_cuda_error_string.argtypes = [i32]
    cdll.cfs_cuda_error_string.restype = ctypes.c_char_p
    return cdll


#: the value types of each stream entry point: float32 and the bf16 values
#: of ``values="bfloat16"`` for every one, and float64 for every one too:
#: the kernels of the float64 route and of the float64 ``DistSpDMV``
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float64: "_f64"}
_FORMS = {
    "sdia_sym": (torch.float32, torch.bfloat16, torch.float64),
    "sdia_gen": (torch.float32, torch.bfloat16, torch.float64),
    "sbell_spmv": (torch.float32, torch.bfloat16, torch.float64),
    "bell2_spmv": (torch.float32, torch.bfloat16, torch.float64),
    "bell2_entries": (torch.float32, torch.bfloat16, torch.float64),
}


def _forms(cdll, name):
    return [getattr(cdll, f"cfs_{name}{_SUFFIX[t]}") for t in _FORMS[name]]


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            with trace.span("cfs.kernels.load"):
                _lib = _bind(path)
        return _lib


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for a stream of ``dtype`` values:
    ``cfs_<name>`` for float32, ``cfs_<name>_bf16`` for bfloat16 (x and y
    float32), ``cfs_<name>_f64`` for float64 (x and y float64)."""
    if dtype not in _FORMS[name]:
        raise TypeError(f"no {name} kernel takes {dtype} values")
    return getattr(lib(), f"cfs_{name}{_SUFFIX[dtype]}")


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a nonzero ``cudaGetLastError()``."""
    if err:
        msg = lib().cfs_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


#: right-hand sides one launch of a stream kernel serves (its widest
#: instance): an SpMM wrapper reads its stream once per group of this many,
#: in every value type (the double paired kernel over planes,
#: ``sbell_planes_kernel``, holds 8 planes in dynamic shared memory)
RHS_GROUP = 8


def xy_dtype(vals) -> torch.dtype:
    """The type of x, y and the sums of a stream whose values are
    ``vals``: float64 for float64 values, else float32 (float32 values, or
    the bfloat16 values of ``values="bfloat16"``)."""
    return torch.float64 if vals.dtype == torch.float64 else torch.float32


def check_dtype(t, name, dtype) -> None:
    """Refuse an x or y operand whose type is not ``dtype``, the type a
    stream's kernel reads x and y in: its values' type, float32 for
    bfloat16 values."""
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype} but the stream's x and y are "
                        f"{dtype}: values are x's type, or bfloat16 when x "
                        "is float32")


def check_values(vals, name, dtype) -> None:
    """Refuse stream values that x and y of ``dtype`` cannot take: the
    values are ``dtype``, or bfloat16 when ``dtype`` is float32."""
    if vals.dtype != dtype and not (dtype == torch.float32
                                    and vals.dtype == torch.bfloat16):
        raise TypeError(f"{name} are {vals.dtype} but x and y are {dtype}: "
                        "values are x's type, or bfloat16 when x is float32")


def count(wrapper, vals_dtype, n: int, *, f64_apart: bool = False) -> None:
    """Add ``n`` kernel launches to ``wrapper``'s count for its values'
    type: ``launches_bf16`` for bfloat16 values (the instances of
    ``values="bfloat16"``), ``launches_f64`` for float64 values where the
    caller passes ``f64_apart`` (the signed diagonal and paired wrappers,
    which take float32 values as well, and whose double instances the
    float64 ``DistSpDMV`` runs), else ``launches`` (the float64-only
    wrappers of ``sdia_df`` and ``bell2_df`` count their double launches
    there)."""
    if vals_dtype == torch.bfloat16:
        wrapper.launches_bf16 += n
    elif vals_dtype == torch.float64 and f64_apart:
        wrapper.launches_f64 += n
    else:
        wrapper.launches += n


def check_planes(t, name, device, dtype, B=None, rows=None) -> int:
    """Check a (B, rows, 128) stack of planes of the stream's ``dtype`` on
    ``device`` whose planes are each contiguous (any plane stride, as the
    kernels index ``plane * stride + row * 128 + lane``); return B."""
    if t.ndim != 3 or t.shape[2] != 128:
        raise ValueError(f"{name} must be (B, rows, 128), got "
                         f"{tuple(t.shape)}")
    check_dtype(t, name, dtype)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stream on {device}")
    if t.shape[0] < 1 or (B is not None and t.shape[0] != B):
        raise ValueError(f"{name} holds {t.shape[0]} planes, expected "
                         f"{B if B is not None else '>= 1'}")
    if rows is not None and t.shape[1] != rows:
        raise ValueError(f"{name} planes must have {rows} rows, got "
                         f"{t.shape[1]}")
    if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != 128):
        raise ValueError(f"{name}: each (rows, 128) plane must be contiguous")
    return t.shape[0]


def launch_groups(name, x3d, y3d, launch, group=RHS_GROUP) -> int:
    """Call ``launch(x_ptr, xs, y_ptr, ys, nr, stream)`` for each group of
    at most ``group`` planes of the plane stacks ``x3d`` and ``y3d``
    (strides in elements), on the current stream of ``y3d``'s device, and
    raise on a refused launch; returns the number of launches. For the
    group whose first plane is ``b0``, x_ptr points at plane ``b0``, or at
    row ``b0`` of an interleaved X (``bell2_kernel.interleave_x``), where
    the group's block starts. Each call is the span ``cfs.launch``: give
    ``launch`` as the entry point with its leading arguments bound
    (``functools.partial``), so that the span holds the native call
    alone."""
    B, xs, ys = y3d.shape[0], x3d.stride(0), y3d.stride(0)
    xb, yb = xs * x3d.element_size(), ys * y3d.element_size()
    x0, y0 = x3d.data_ptr(), y3d.data_ptr()
    fn = getattr(launch, "func", launch)
    with torch.cuda.device(y3d.device):
        stream = torch.cuda.current_stream(y3d.device).cuda_stream
        for b0 in range(0, B, group):
            planes = (x0 + b0 * xb, xs, y0 + b0 * yb, ys,
                      min(group, B - b0), stream)
            with trace.span("cfs.launch", entry=fn.__name__):
                err = launch(*planes)
            check(err, name)
    return -(-B // group)
