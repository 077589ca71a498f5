"""HPCG's problem: the 27-point stencil of ``GenerateProblem`` (HPCG 3.1,
``src/GenerateProblem.cpp``) on an nx x ny x nz grid, as its lower
triangle (the diagonal included) in CSR with columns ascending.

Row ``ix + nx * (iy + ny * iz)`` couples to every grid point of its
3 x 3 x 3 box that lies in the grid: 26 on the diagonal, -1 off it, as
HPCG sets them. HPCG requires double precision, so the values are
float64.
"""

from __future__ import annotations

import numpy as np


def make(cfg: dict):
    """(n, indptr int64, indices int32, data float64) of ``cfg``'s grid."""
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    n = nx * ny * nz
    # the 13 neighbours below the diagonal and the diagonal itself, in
    # ascending column offset: lexicographic (dz, dy, dx) <= 0
    offs = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1) if (dz, dy, dx) <= (0, 0, 0)]
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    keep = np.empty((n, len(offs)), bool)
    shift = np.empty(len(offs), np.int64)
    for k, (dz, dy, dx) in enumerate(offs):
        okx = (ix + dx >= 0) & (ix + dx < nx)
        oky = (iy + dy >= 0) & (iy + dy < ny)
        okz = (iz + dz >= 0) & (iz + dz < nz)
        keep[:, k] = (okz[:, None, None] & oky[None, :, None]
                      & okx[None, None, :]).ravel()
        shift[k] = dz * nx * ny + dy * nx + dx
    rows, ks = np.nonzero(keep)  # row-major: by row, then by offset
    indices = (rows + shift[ks]).astype(np.int32)
    data = np.where(shift[ks] == 0, 26.0, -1.0)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return n, indptr, indices, data
