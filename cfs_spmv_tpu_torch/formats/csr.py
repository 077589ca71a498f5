"""Host-side CSR container.

Analog of the reference's ``CSRMatrix`` storage layer
(``csr_matrix.hpp:96-125``) minus the tuned state: this build keeps CSR
purely as a host-side canonical format from which device layouts (BELL,
SSS, BSR) are planned. Construction from COO mirrors the reference's CSR
fill with empty-row handling (``csr_matrix.tpp:74-107``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .coo import COO

__all__ = ["CSR"]


@dataclasses.dataclass
class CSR:
    nrows: int
    ncols: int
    indptr: np.ndarray  # (nrows+1,) int64
    indices: np.ndarray  # (nnz,) int32, col-sorted within each row
    data: np.ndarray  # (nnz,)
    symmetric: bool = False  # if True, holds only the lower triangle

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_coo(coo: COO) -> "CSR":
        src = coo
        coo = coo.canonicalize()
        indptr = np.zeros(coo.nrows + 1, dtype=np.int64)
        counts = np.bincount(coo.row, minlength=coo.nrows)
        np.cumsum(counts, out=indptr[1:])
        # canonicalize may return the input unchanged (already sorted):
        # copy val then so the CSR never aliases caller-owned buffers
        # (indices are fresh either way — astype always copies)
        val = coo.val.copy() if coo is src else coo.val
        return CSR(
            coo.nrows,
            coo.ncols,
            indptr,
            coo.col.astype(np.int32),
            val,
            coo.symmetric,
        )

    @staticmethod
    def from_scipy(mat, *, symmetric: bool = False) -> "CSR":
        """Adopt any scipy.sparse matrix (converted to CSR).

        ``symmetric=True`` asserts the matrix is symmetric and keeps
        only the lower triangle (the SSS storage contract).
        """
        import scipy.sparse as sp

        m = sp.csr_matrix(mat)
        m.sum_duplicates()
        m.sort_indices()
        if symmetric:
            if (m != m.T).nnz:  # noqa: SIM201 — scipy sparse compare
                raise ValueError("symmetric=True but matrix is not")
            m = sp.csr_matrix(sp.tril(m))
        return CSR(
            m.shape[0], m.shape[1],
            m.indptr.astype(np.int64), m.indices.astype(np.int32),
            m.data.copy(), symmetric,
        )

    def to_scipy(self):
        """Export as scipy.sparse.csr_matrix (symmetric storage is
        expanded to the full matrix)."""
        import scipy.sparse as sp

        coo = self.to_coo()
        if self.symmetric:
            coo = coo.expand_symmetric()
        return sp.csr_matrix(
            (coo.val, (coo.row, coo.col)), shape=(self.nrows, self.ncols)
        )

    def to_coo(self) -> COO:
        row = np.repeat(
            np.arange(self.nrows, dtype=np.int32), np.diff(self.indptr)
        )
        return COO(self.nrows, self.ncols, row, self.indices.copy(),
                   self.data.copy(), self.symmetric)

    def transpose(self) -> "CSR":
        """CSR of the transpose (used to build the SSS upper stream)."""
        coo = self.to_coo()
        t = COO(self.ncols, self.nrows, coo.col, coo.row, coo.val, False)
        return CSR.from_coo(t)

    def split_triangle(self) -> tuple["CSR", np.ndarray, "CSR"]:
        """Split into (strict lower CSR, diagonal array, strict upper CSR).

        The symmetric formats store diag separately per the reference's
        ``SymThreadData`` layout (``csr_matrix.hpp:221-277``).
        """
        coo = self.to_coo()
        diag = np.zeros(min(self.nrows, self.ncols), dtype=self.dtype)
        on = coo.row == coo.col
        diag[coo.row[on]] = coo.val[on]
        lower = coo.row > coo.col
        upper = coo.row < coo.col
        lo = COO(self.nrows, self.ncols, coo.row[lower], coo.col[lower],
                 coo.val[lower], False)
        up = COO(self.nrows, self.ncols, coo.row[upper], coo.col[upper],
                 coo.val[upper], False)
        return CSR.from_coo(lo), diag, CSR.from_coo(up)

    def validate(self) -> "CSR":
        """Structural checks (the reference exits on bad input at parse
        time, ``mmf.hpp:189,210-236``; here malformed user-built arrays
        get a diagnosable error instead of a wrong kernel result)."""
        if self.indptr.shape != (self.nrows + 1,):
            raise ValueError(
                f"indptr has {self.indptr.shape[0]} entries, want "
                f"nrows+1={self.nrows + 1}"
            )
        if self.indptr[0] != 0 or self.indptr[-1] != self.nnz:
            raise ValueError("indptr must run from 0 to nnz")
        if np.any(np.diff(self.indptr) < 0):
            raise ValueError("indptr must be non-decreasing")
        if self.nnz and (
            self.indices.min() < 0 or self.indices.max() >= self.ncols
        ):
            raise ValueError("column index out of range")
        row = np.repeat(
            np.arange(self.nrows, dtype=np.int64), np.diff(self.indptr)
        )
        if self.nnz > 1:
            same_row = row[1:] == row[:-1]
            if np.any(same_row & (self.indices[1:] <= self.indices[:-1])):
                raise ValueError(
                    "column indices must be strictly increasing per row"
                )
        if self.symmetric and self.nnz and np.any(
            self.indices.astype(np.int64) > row
        ):
            raise ValueError(
                "symmetric storage must hold only the lower triangle"
            )
        return self

    def size_bytes(self) -> int:
        """Memory footprint (analog of ``CSRMatrix::size()``,
        ``csr_matrix.tpp:190-228``)."""
        return (
            self.indptr.nbytes + self.indices.nbytes + self.data.nbytes
        )

    def spmv_host(self, x: np.ndarray, *, absolute: bool = False) -> np.ndarray:
        """Serial host oracle, the analog of ``cpu_mv_serial``
        (``csr_matrix.tpp:2664-2681``) used by the differential tests
        (``test_spmv_mmf.cpp:85-89``). Handles the symmetric fold-in like
        ``cpu_mv_sym_serial`` (``csr_matrix.tpp:2706-2729``).

        ``absolute=True`` computes ``|A| @ |x|``, the componentwise
        backward-error scale used by the fp32 tolerance checks."""
        a = self
        out_dtype = np.result_type(a.dtype, x.dtype)
        data = np.abs(a.data) if absolute else a.data
        x = np.abs(x) if absolute else x
        row = np.repeat(np.arange(a.nrows), np.diff(a.indptr))
        # bincount is ~50x faster than np.add.at for the big oracles
        acc = np.bincount(
            row, weights=(data * x[a.indices]).astype(np.float64),
            minlength=a.nrows,
        )
        if a.symmetric:
            off = row != a.indices
            acc += np.bincount(
                a.indices[off],
                weights=(data[off] * x[row[off]]).astype(np.float64),
                minlength=a.nrows,
            )
        return acc.astype(out_dtype)
