"""Host-side COO container.

Canonical in-memory representation produced by the MMF loader; the analog
of the reference's ``MMF<I,V>`` element stream (``mmf.hpp:46-105``) but as
vectorized NumPy arrays rather than a forward iterator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["COO"]


@dataclasses.dataclass
class COO:
    nrows: int
    ncols: int
    row: np.ndarray  # int32/int64, sorted by (row, col) when canonical
    col: np.ndarray
    val: np.ndarray
    symmetric: bool = False  # if True, arrays hold only the lower triangle

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def nnz_full(self) -> int:
        """Logical nnz of the full (expanded) matrix."""
        if not self.symmetric:
            return self.nnz
        ndiag = int(np.count_nonzero(self.row == self.col))
        return 2 * self.nnz - ndiag

    @property
    def dtype(self):
        return self.val.dtype

    def canonicalize(self) -> "COO":
        """Sort by (row, col) and sum duplicate coordinates."""
        # combined-key stable argsort == lexsort((col, row)) but one
        # radix pass instead of two mergesorts (row*ncols+col is unique
        # per coordinate, fits int64 for any nrows*ncols < 2^63)
        if self.nrows > (2**62) // max(self.ncols, 1):
            order = np.lexsort((self.col, self.row))  # key would overflow
        else:
            m = np.int64(max(self.ncols, 1))
            key = self.row.astype(np.int64) * m
            key += self.col
            if len(key) == 0 or bool(np.all(key[1:] > key[:-1])):
                # already sorted, no duplicates: the common case when a
                # canonical COO flows into CSR.from_coo — skip the
                # resort (a full radix pass + 3 gathers at 40M+ nnz)
                return self
            order = np.argsort(key, kind="stable")
        r, c, v = self.row[order], self.col[order], self.val[order]
        if len(r):
            keep = np.empty(len(r), bool)
            keep[0] = True
            keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            if not keep.all():
                seg = np.cumsum(keep) - 1
                v = np.bincount(seg, weights=v, minlength=keep.sum()).astype(v.dtype)
                r, c = r[keep], c[keep]
        return COO(self.nrows, self.ncols, r, c, v, self.symmetric)

    def expand_symmetric(self) -> "COO":
        """Mirror the lower triangle into a full general COO
        (ref ``mmf.hpp:279-293`` load-time expansion)."""
        if not self.symmetric:
            return self
        off = self.row != self.col
        r = np.concatenate([self.row, self.col[off]])
        c = np.concatenate([self.col, self.row[off]])
        v = np.concatenate([self.val, self.val[off]])
        out = COO(self.nrows, self.ncols, r, c, v, symmetric=False)
        return out.canonicalize()

    def to_dense(self) -> np.ndarray:
        """Small-matrix densifier (test oracle only)."""
        a = self.expand_symmetric() if self.symmetric else self
        d = np.zeros((a.nrows, a.ncols), dtype=a.val.dtype)
        np.add.at(d, (a.row, a.col), a.val)
        return d

    @staticmethod
    def random(
        nrows: int,
        ncols: int,
        nnz_per_row: float,
        *,
        dtype=np.float32,
        symmetric: bool = False,
        bandwidth: int | None = None,
        seed: int = 0,
    ) -> "COO":
        """Random test matrix generator.

        ``bandwidth`` limits |col - row| to produce banded (FEM-like)
        structure; ``None`` gives uniform scatter. Mirrors the role of the
        reference's external SuiteSparse inputs, which are not vendored
        (SURVEY §4).
        """
        rng = np.random.default_rng(seed)
        n_entries = int(nrows * nnz_per_row)
        row = rng.integers(0, nrows, n_entries)
        if bandwidth is None:
            col = rng.integers(0, ncols, n_entries)
        else:
            off = rng.integers(-bandwidth, bandwidth + 1, n_entries)
            col = np.clip(row + off, 0, ncols - 1)
        val = rng.uniform(-1.0, 1.0, n_entries).astype(dtype)
        if symmetric:
            assert nrows == ncols
            keep = row >= col
            row, col, val = row[keep], col[keep], val[keep]
            # ensure a full diagonal so the SSS diagonal path is exercised
            diag = np.arange(nrows)
            row = np.concatenate([row, diag])
            col = np.concatenate([col, diag])
            val = np.concatenate([val, rng.uniform(1.0, 2.0, nrows).astype(dtype)])
        coo = COO(nrows, ncols, row.astype(np.int32), col.astype(np.int32),
                  val.astype(dtype), symmetric=symmetric)
        return coo.canonicalize()
