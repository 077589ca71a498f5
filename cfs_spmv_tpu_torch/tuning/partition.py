"""Partitioners: balanced row-tile assignment across devices.

Host copy of ``cfs_spmv_tpu/tuning/partition.py`` for the PyTorch port.

TPU-native analog of the reference's row partitioners
(``csr_matrix.tpp:403-639``):

- ``partition_tiles_by_count`` ↔ ``partition_by_nrows`` (tpp:403-435):
  equal tile counts, BlkFactor-aligned (here: 128-row tiles).
- ``partition_tiles_by_nnz`` ↔ ``partition_by_nnz`` (tpp:437-541): equal
  nonzeros per device with tile-aligned split points.
- ``estimate_imbalance`` ↔ the reference's load-imbalance estimator
  (``csr_matrix.tpp:1641-1681``).

The METIS/KaHIP conflict partitioner (tpp:543-639) has no TPU analog:
there is no inter-device scatter to minimize; locality-aware placement to
reduce halo traffic is a planned extension (SURVEY §2 table).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "tile_nnz_histogram",
    "partition_tiles_by_count",
    "partition_tiles_by_nnz",
    "estimate_imbalance",
]

LANES = 128


def tile_nnz_histogram(indptr: np.ndarray, num_tiles: int) -> np.ndarray:
    """nnz per 128-row tile from a CSR indptr."""
    n = len(indptr) - 1
    row_nnz = np.diff(indptr)
    tiles = np.arange(n) // LANES
    out = np.zeros(num_tiles, np.int64)
    np.add.at(out, tiles, row_nnz)
    return out


def partition_tiles_by_count(num_tiles: int, ndev: int) -> np.ndarray:
    """Contiguous equal-count tile ranges; returns boundaries (ndev+1,)."""
    return np.linspace(0, num_tiles, ndev + 1).round().astype(np.int64)


def partition_tiles_by_nnz(tile_nnz: np.ndarray, ndev: int) -> np.ndarray:
    """Contiguous tile ranges with ~equal nnz per device.

    Greedy prefix split at nearest tile boundary, the tile-aligned analog
    of the reference's equal-nnz row splits (``csr_matrix.tpp:437-541``).
    """
    num_tiles = len(tile_nnz)
    csum = np.concatenate([[0], np.cumsum(tile_nnz)])
    total = csum[-1]
    bounds = np.zeros(ndev + 1, np.int64)
    bounds[-1] = num_tiles
    for d in range(1, ndev):
        target = total * d / ndev
        bounds[d] = np.searchsorted(csum, target)
    # enforce monotonicity (degenerate distributions)
    np.maximum.accumulate(bounds, out=bounds)
    bounds[-1] = num_tiles
    return bounds


def estimate_imbalance(work_per_dev: np.ndarray) -> float:
    """max/mean - 1 (0 = perfectly balanced), ref ``tpp:1641-1681``."""
    w = np.asarray(work_per_dev, np.float64)
    mean = w.mean() if len(w) else 0.0
    return float(w.max() / mean - 1.0) if mean > 0 else 0.0
