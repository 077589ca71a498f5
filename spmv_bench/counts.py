"""The yardstick's counts: the canonical bytes and operations of an apply,
and the table of peaks they are held against.

The canonical count is the work any implementation of ``Y = A X`` has to
do, whatever plan the program chooses: each stored value of the matrix
read once (for a symmetric matrix, its lower triangle with the diagonal,
in the configuration's precision), X read once and Y written once (n x B
vectors each). No index or structure bytes are counted, so no plan can
read over 100% of the roofline. Operations are 2 per logical nonzero
(both triangles) and right-hand side.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Peak:
    """A card's published peaks (NVIDIA data sheets; dense rates, outside
    the tensor cores for float32 and float64)."""

    name: str
    hbm_bytes_s: float
    fp32_flops: float
    fp64_flops: float
    l2_bytes: int


#: by the name ``torch.cuda.get_device_name()`` gives: the SXM5 part
_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak("H100 SXM", 3.35e12, 67e12, 34e12,
                                  50 * 2**20),
}


def peak_for(device_name: str) -> Peak:
    """The peaks of the card named ``device_name``; a card the table does
    not hold raises (a roofline against a guessed peak is no reading)."""
    try:
        return _PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no peaks known for the card {device_name!r}") \
            from None


def itemsize(precision: str) -> int:
    return np.dtype(precision).itemsize


def value_bytes(stored_nnz: int, precision: str) -> int:
    """Bytes of the stored values, each read once."""
    return stored_nnz * itemsize(precision)


def apply_bytes(n: int, stored_nnz: int, rhs: int, precision: str) -> int:
    """Canonical bytes of one ``Y = A X`` with X and Y (n, rhs): the
    stored values, X read once, Y written once."""
    return value_bytes(stored_nnz, precision) + 2 * n * rhs * itemsize(precision)


def apply_flops(logical_nnz: int, rhs: int) -> int:
    """Operations of one ``Y = A X``: a multiply and an add per logical
    nonzero and right-hand side."""
    return 2 * logical_nnz * rhs


def bound_s(nbytes: int, flops: int, peak: Peak, precision: str) -> float:
    """The least time the card could take: the larger of the bytes over
    peak bandwidth and the operations over peak rate."""
    rate = peak.fp64_flops if itemsize(precision) == 8 else peak.fp32_flops
    return max(nbytes / peak.hbm_bytes_s, flops / rate)
