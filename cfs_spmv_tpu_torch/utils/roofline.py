"""Per-card roofline model and speed-of-light estimators.

Port of ``cfs_spmv_tpu/utils/roofline.py``. The reference reports
GFLOP/s = 2*nnz*iters/t (``bench_spmv_mmf.cpp:168``) with no roofline
context; this module derives the nnz/s ceiling from the card's device
memory bandwidth and the bytes each kernel moves per nonzero. The known
cards are NVIDIA's H100 parts, with the figures of NVIDIA's data sheets,
and ``cpu`` for runs without CUDA.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ChipSpec", "detect_chip", "spmv_bytes_per_nnz", "speed_of_light_nnz_s"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bw_bytes_s: float  # peak device memory (HBM) bandwidth
    l2_bytes: int  # the last-level cache a working set may sit in
    f32_flops: float  # float32 outside the tensor cores
    f64_flops: float  # float64 outside the tensor cores


#: spec-sheet figures (NVIDIA H100 data sheet; the float32 and float64
#: rates are the SXM part's, used for every H100 form)
_KNOWN = {
    "h100-sxm": ChipSpec("h100-sxm", 3.35e12, 50 * 2**20, 67e12, 34e12),
    "h100-pcie": ChipSpec("h100-pcie", 2.0e12, 50 * 2**20, 67e12, 34e12),
    "h100-nvl": ChipSpec("h100-nvl", 3.9e12, 50 * 2**20, 67e12, 34e12),
    "cpu": ChipSpec("cpu", 50e9, 1 << 30, 5e11, 2.5e11),
}


def _spec_for(name: str) -> ChipSpec | None:
    """The known card a CUDA device name denotes ("NVIDIA H100 80GB
    HBM3" is the SXM5 part), or None."""
    n = name.upper()
    if "H100" not in n:
        return None
    if "NVL" in n:
        return _KNOWN["h100-nvl"]
    if "PCIE" in n:
        return _KNOWN["h100-pcie"]
    return _KNOWN["h100-sxm"]


def detect_chip() -> ChipSpec:
    """The spec of CUDA device 0 by its name; ``cpu`` without CUDA. An
    unknown card warns and is taken for an H100 SXM."""
    import torch

    if not torch.cuda.is_available():
        return _KNOWN["cpu"]
    name = torch.cuda.get_device_properties(0).name
    spec = _spec_for(name)
    if spec is not None:
        return spec
    from .logging import warn

    warn(
        "roofline: unknown card %r; assuming H100 SXM specs "
        "(roofline percentages may be wrong on other cards)", name,
    )
    return _KNOWN["h100-sxm"]


def spmv_bytes_per_nnz(
    *,
    value_bytes: int = 4,
    index_bytes: int = 4,
    nnz: int,
    nrows: int,
    ncols: int,
    vector_bytes: int = 4,
    passes: int = 1,
) -> float:
    """Average device-memory bytes moved per nonzero for a streaming SpMV
    kernel.

    Per nnz: value + packed index; per matrix pass: read x once, write y.
    ``passes`` counts how many times the nnz stream is traversed (SSS = 2
    streams each traversed once == 1 pass over 2*nnz values).
    """
    stream = (value_bytes + index_bytes) * nnz * passes
    vecs = vector_bytes * (ncols + nrows)
    return (stream + vecs) / max(nnz, 1)


def speed_of_light_nnz_s(chip: ChipSpec, bytes_per_nnz: float) -> float:
    """Bandwidth-roofline nonzeros/second ceiling."""
    return chip.hbm_bw_bytes_s / max(bytes_per_nnz, 1e-12)
