"""The float64 plan whose one-sided stream is built as an entry list.

``tune.build_fp64_plan(csr, entries=True)`` gives it for a symmetric
matrix whose peel takes diagonals: the peel's dense lower diagonals as the grid plan has them, and
what the peel leaves of the lower triangle as plain arrays, with no slot
search and no chunk grid. The upload (``spmv.fp64_to_device``) expands
those arrays to both triangles on the plan's device and sorts them by row
(``bell2_kernel.lower_entries``): an ``EntryStream`` of the same live
entries that the grid plan's residual is compacted to, each row's columns
ascending. Past ``tune.FP64_ENTRIES_MIN_NNZ`` stored entries ``tune``
plans such a matrix so; the plan cache keys it apart
(``fp64_stream="entries"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.sdia import SDiaPlan

__all__ = ["Fp64EntriesPlan"]


@dataclasses.dataclass
class Fp64EntriesPlan:
    """A symmetric float64 plan: ``dia``, the dense lower diagonals with
    the main one halved (None where the peel took nothing), and the rest
    of the lower triangle (``row``, ``col`` int32 and ``val`` float64 in
    CSR order, stored zeros kept, as the grid plan keeps them). ``nnz``
    counts the stream's stored entries once expanded, both triangles: the
    grid plan's ``nnz`` of the same matrix."""

    nrows: int
    ncols: int
    nnz: int
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    dia: SDiaPlan | None = None

    @classmethod
    def from_lower(cls, n: int, row, col, val,
                   dia: SDiaPlan | None) -> "Fp64EntriesPlan":
        """The plan of the lower-triangle entries (``row``, ``col``,
        ``val``) that ``dia`` leaves."""
        row = np.ascontiguousarray(row, np.int32)
        col = np.ascontiguousarray(col, np.int32)
        val = np.ascontiguousarray(val, np.float64)
        nnz = 2 * len(row) - int(np.count_nonzero(row == col))
        return cls(n, n, nnz, row, col, val, dia)

    @property
    def padding_ratio(self) -> float:
        return 1.0

    def stream_bytes(self) -> int:
        """Bytes that reach the card: 16 an entry, and the planes."""
        return 16 * self.nnz + (0 if self.dia is None
                                else self.dia.stream_bytes())
