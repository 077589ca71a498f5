"""End-to-end example: solve a 2-D Poisson problem with CG on the card.

The ``cfs_spmv_tpu_torch`` form of ``examples/cg_poisson.py``: builds the
standard 5-point Laplacian (SPD, symmetric storage), tunes it into the
dense-diagonal stream, and runs Conjugate Gradient on the card, its
iteration replayed as a CUDA graph with no host sync inside the loop.
Run: python examples/cg_poisson_torch.py [grid_side]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfs_spmv_tpu_torch import COO, CSR, Format, SparseMatrix, SpDMV, Tuning  # noqa: E402
from cfs_spmv_tpu_torch.models.solvers import cg  # noqa: E402


def laplacian_2d(g: int, dtype=np.float32) -> CSR:
    """5-point stencil on a g x g grid, lower triangle + diagonal."""
    n = g * g
    i = np.arange(n, dtype=np.int64)
    rows = [i]
    cols = [i]
    vals = [np.full(n, 4.0)]
    # left neighbor (d = 1), skipping row starts
    m = i % g != 0
    rows.append(i[m]), cols.append(i[m] - 1), vals.append(np.full(m.sum(), -1.0))
    # down neighbor (d = g)
    m = i >= g
    rows.append(i[m]), cols.append(i[m] - g), vals.append(np.full(m.sum(), -1.0))
    coo = COO(
        n, n,
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        symmetric=True,
    ).canonicalize()
    return CSR.from_coo(coo)


def main() -> int:
    g = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    A = SparseMatrix.create(laplacian_2d(g), Format.SSS)
    spmv = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32)  # on the card

    # manufactured solution: x* random, b = A x*
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(A.nrows).astype(np.float32)
    b = spmv(x_true)

    x, resid, hist = cg(spmv, b, iters=4 * g)
    err = float(torch.max(torch.abs(x.cpu() - torch.as_tensor(x_true))))
    print(
        f"grid {g}x{g} (n={A.nrows}, nnz={A.nnz_full}): "
        f"CG residual {float(resid):.3e}, max error {err:.3e}, "
        f"first->last residual {float(hist[0]):.3e} -> {float(hist[-1]):.3e}"
    )
    return 0 if err < 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
