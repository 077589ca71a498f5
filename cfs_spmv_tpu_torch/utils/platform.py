"""Platform enums, tolerances and small numeric helpers.

Host copy of ``cfs_spmv_tpu/utils/platform.py`` for the PyTorch port: the
reference's platform substrate (``include/utils/platform.hpp:20-37`` in
cfs-spmv) with ``Kernel{SpDMV}``, ``Tuning{None,Aggressive}`` and
``Format{none,csr,sss,hyb}`` enums plus a relative-epsilon float
comparator ``isEqual`` (rel-eps 1e-4 float / 1e-8 double,
``platform.hpp:27-37``). ``Platform`` names the two places a tuned matrix
can live in the port, by the string its ``device=`` arguments take.
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = [
    "Platform",
    "Kernel",
    "Tuning",
    "Format",
    "is_equal",
    "allclose_spmv",
    "rel_tolerance",
    "iceildiv",
    "round_up",
]


class Platform(enum.Enum):
    """Execution platform for a tuned matrix (ref ``platform.hpp:20``):
    the value is the ``device=`` string of ``SpDMV``, ``SpDMM`` and
    ``tune``."""

    CUDA = "cuda"  # the card: the hand-written kernels, the default
    CPU = "cpu"  # the kernels' plain PyTorch twins, as the tests run


class Kernel(enum.Enum):
    """Kernel families the tuner can target (ref ``platform.hpp:22``).

    The reference only has SpDMV (sparse matrix · dense vector). We add
    SpDMM (sparse · dense matrix, multi-RHS) as a first-class kernel.
    """

    SpDMV = "spdmv"
    SpDMM = "spdmm"


class Tuning(enum.Enum):
    """Preprocessing effort (ref ``platform.hpp:21``)."""

    NONE = "none"  # direct layout, no window/balance optimization
    AGGRESSIVE = "aggressive"  # window optimization, symmetric compression


class Format(enum.Enum):
    """Storage/layout formats (ref ``platform.hpp:23``: none/csr/sss/hyb).

    - CSR/COO are host-side canonical formats.
    - BELL is the banded sliced-ELL layout (the hot format),
      replacing the reference's tuned CSR.
    - SSS is symmetric storage: diagonal + strict lower triangle only, with
      the transpose contribution folded in (ref ``csr_matrix.tpp:641-1716``)
      — realized here as two BELL streams instead of conflict-free coloring.
    - HYB mirrors the reference's low/high-bandwidth split
      (``csr_matrix.tpp:313-401``): BELL main stream + scattered spill
      stream.
    - BSR is a block-sparse row host format; it runs the SSS or the
      general path.
    """

    NONE = "none"
    COO = "coo"
    CSR = "csr"
    SSS = "sss"
    HYB = "hyb"
    BELL = "bell"
    BSR = "bsr"


#: Relative tolerances used by the differential tests, matching the
#: reference's ``isEqual`` (``platform.hpp:27-37``).
_REL_EPS = {
    np.dtype(np.float32): 1e-4,
    np.dtype(np.float64): 1e-8,
}


def rel_tolerance(dtype) -> float:
    """Relative tolerance for a dtype (ref ``platform.hpp:27-37``)."""
    dt = np.dtype(dtype)
    if dt in _REL_EPS:
        return _REL_EPS[dt]
    # by size, not by name: numpy knows "bfloat16" only once ml_dtypes
    # is imported, which nothing in this package does
    if dt.itemsize <= 2:
        return 5e-2
    raise ValueError(f"no tolerance defined for dtype {dt}")


def is_equal(a, b, dtype=None) -> bool:
    """Element-wise relative comparison, vectorized analog of the
    reference's scalar ``isEqual`` (``platform.hpp:27-37``):

        |a - b| <= eps * max(|a|, |b|)   (with exact-zero handled)
    """
    a = np.asarray(a)
    b = np.asarray(b)
    dt = np.dtype(dtype) if dtype is not None else np.promote_types(a.dtype, b.dtype)
    eps = rel_tolerance(dt)
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    scale = np.maximum(np.abs(a).astype(np.float64), np.abs(b).astype(np.float64))
    return bool(np.all(diff <= eps * np.maximum(scale, np.finfo(np.float64).tiny) + 0.0))


def allclose_spmv(
    y, y_ref, dtype=None, nnz_per_row: float = 1.0, scale=None
) -> bool:
    """Tolerance check for SpMV results.

    The reference compares with a fixed relative epsilon
    (``test_spmv_mmf.cpp:94-109``) and only in fp64. For fp32 a pure
    relative check breaks on catastrophic cancellation (|y_i| << Σ|a_ij
    x_j|), so the backward-error scale ``scale = (|A| |x|)_i`` may be
    passed; the error bound is then ``eps * sqrt(nnz/row) * scale`` — the
    standard componentwise bound for reordered summation.
    """
    dt = np.dtype(dtype) if dtype is not None else np.asarray(y).dtype
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    eps = rel_tolerance(dt) * max(1.0, float(np.sqrt(max(nnz_per_row, 1.0))))
    if scale is None:
        denom = np.maximum(np.abs(y), np.abs(y_ref))
    else:
        denom = np.maximum(
            np.asarray(scale, np.float64),
            np.maximum(np.abs(y), np.abs(y_ref)),
        )
    denom = np.maximum(denom, np.finfo(np.float64).tiny)
    return bool(np.all(np.abs(y - y_ref) <= eps * denom))


def iceildiv(a: int, b: int) -> int:
    """Ceiling division (ref ``platform.hpp:25``)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (tile alignment helper)."""
    return ((x + m - 1) // m) * m
