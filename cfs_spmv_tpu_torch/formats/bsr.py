"""BSR — block-sparse row host format.

Host copy of ``cfs_spmv_tpu/formats/bsr.py``, code unchanged (the
container it builds is held byte-identical to the reference's by
``tests/test_torch_formats.py``).

BASELINE config 3 compares BSR against CSR on block-structured FEM
matrices (audikw_1-like). On CPUs BSR wins through register blocking
and halved index traffic; here the same structure is exploited by the
planner's *diagonal units* (a dense b×b block contributes b exact
diagonals), so the tuned execution path is shared: ``tune(fmt=BSR)``
stores the block structure (detection, size accounting — the index
savings are real) and plans element-level SDIA/SBELL/BELL2 streams from
it. The format is the contract; the kernel choice is the tuner's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.logging import info
from .coo import COO
from .csr import CSR

__all__ = ["BSR", "detect_block_size"]


@dataclasses.dataclass
class BSR:
    nrows: int
    ncols: int
    b: int  # block edge
    indptr: np.ndarray  # (nrowsb + 1,) block-row pointers
    indices: np.ndarray  # (nblocks,) block-column indices
    data: np.ndarray  # (nblocks, b, b) dense blocks
    symmetric: bool = False

    @property
    def nblocks(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nnz_stored(self) -> int:
        """Dense slots stored (includes explicit zeros inside blocks)."""
        return self.data.size

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.data))

    def size_bytes(self) -> int:
        """Index traffic is 1/b² of element CSR (the BSR selling point,
        measured by the bench's size column)."""
        return self.indptr.nbytes + self.indices.nbytes + self.data.nbytes

    @staticmethod
    def from_csr(csr: CSR, b: int) -> "BSR":
        coo = csr.to_coo()
        nrb = -(-csr.nrows // b)
        ncb = -(-csr.ncols // b)
        br = coo.row.astype(np.int64) // b
        bc = coo.col.astype(np.int64) // b
        key = br * ncb + bc
        uniq, inv = np.unique(key, return_inverse=True)
        data = np.zeros((len(uniq), b, b), csr.dtype)
        data[inv, coo.row.astype(np.int64) % b,
             coo.col.astype(np.int64) % b] = coo.val
        ubr = (uniq // ncb).astype(np.int64)
        indptr = np.zeros(nrb + 1, np.int64)
        np.cumsum(np.bincount(ubr, minlength=nrb), out=indptr[1:])
        return BSR(
            csr.nrows, csr.ncols, b, indptr,
            (uniq % ncb).astype(np.int32), data, csr.symmetric,
        )

    def to_csr(self) -> CSR:
        b = self.b
        br = np.repeat(np.arange(len(self.indptr) - 1), np.diff(self.indptr))
        # element coordinates of every nonzero slot
        blk, ri, ci = np.nonzero(self.data)
        row = br[blk] * b + ri
        col = self.indices[blk].astype(np.int64) * b + ci
        coo = COO(
            self.nrows, self.ncols,
            row.astype(np.int64), col, self.data[blk, ri, ci],
            self.symmetric,
        )
        return CSR.from_coo(coo)


def detect_block_size(
    csr: CSR, candidates=(8, 6, 4, 3, 2), min_fill: float = 0.67
) -> int:
    """Largest block edge whose blocks are ≥ ``min_fill`` dense — the
    auto-tuning knob the bench's BSR-vs-CSR comparison exercises."""
    coo = csr.to_coo()
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    for b in candidates:
        ncb = -(-csr.ncols // b)
        nblk = len(np.unique((r // b) * ncb + (c // b)))
        fill = csr.nnz / max(nblk * b * b, 1)
        if fill >= min_fill:
            info("bsr: block=%d fill=%.2f", b, fill)
            return b
    return 1
