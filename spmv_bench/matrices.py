"""The benchmark's own matrix of a configuration, made by the generator the
configuration names (``generators/<name>.py``) in every run."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import spec


@dataclasses.dataclass
class Matrix:
    """A symmetric matrix as its lower triangle, the diagonal included, in
    CSR with columns ascending."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def stored_nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def diagonal_nnz(self) -> int:
        rows = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))
        return int(np.count_nonzero(rows == self.indices))

    @property
    def logical_nnz(self) -> int:
        """Nonzeros of the full matrix, both triangles."""
        return 2 * self.stored_nnz - self.diagonal_nnz


def make(cfg: dict) -> Matrix:
    """The matrix of ``cfg``, made by its generator in memory: a vectorised
    function of the configuration, cheaper to run than to load back."""
    return Matrix(*spec.generator(cfg["generator"]).make(cfg))
