"""Differential correctness harness (ref ``test/test_spmv_mmf.cpp:31-120``).

Port of ``cfs_spmv_tpu/cli/test_spmv_mmf.py``. Loads the matrix in the
requested format, tunes aggressively onto the device, runs the kernel
twice (state-reuse check, ref ``:82-83``), re-loads as plain CSR with
``Tuning.NONE`` as the oracle (ref ``:85-89``, the general one-sided
path), and compares element-wise within the ``isEqual`` tolerances
(``platform.hpp:27-37``) with a componentwise backward-error scale; the
result is also checked against the float64 host oracle. Prints
``PASSED!`` or ``FAILED!``.

Usage::

    python -m cfs_spmv_tpu_torch.cli.test_spmv_mmf <file.mtx> <fmt>
        [--device cuda|cpu] [--dp]

``--device`` defaults to ``cuda`` and raises where CUDA is absent;
``--dp`` runs everything in float64 (the reference binary's pinned type,
``test_spmv_mmf.cpp:17``) at the 1e-8 tolerance.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import parse_format


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cfs_spmv_tpu_torch.cli.test_spmv_mmf",
        description="tuned SpMV against the untuned CSR oracle",
    )
    ap.add_argument("mmf_file")
    ap.add_argument("format", help="0=csr 1=sss 2=hyb, or a format name")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dp", action="store_true", help="float64")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from .. import SparseMatrix, SpDMV
    from ..utils.logging import info
    from ..utils.platform import Format, Tuning, allclose_spmv

    fmt = parse_format(args.format)
    A = SparseMatrix.create(args.mmf_file, fmt)
    M, N = A.nrows, A.ncols
    info("sparsity %.4f %%", (1 - A.nnz_full / M / N) * 100)

    dtype = np.float64 if args.dp else np.float32
    x = np.random.default_rng(0).uniform(10.01, 20.42, N).astype(dtype)

    fn = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype, device=args.device)
    y = None
    for _ in range(2):  # reuse across calls, ref :82-83
        y = fn(x).cpu().numpy()

    # oracle: untuned CSR path on the same input (ref :85-89)
    A_test = SparseMatrix.create(args.mmf_file, Format.CSR)
    y_test = SpDMV(A_test, Tuning.NONE, dtype=dtype,
                   device=args.device)(x).cpu().numpy()

    xd = x.astype(np.float64)
    scale = A.csr.spmv_host(xd, absolute=True)
    nnz_per_row = A.nnz_full / max(M, 1)
    passed = allclose_spmv(
        y, y_test, dtype, nnz_per_row=nnz_per_row, scale=scale
    ) and allclose_spmv(
        y, A.csr.spmv_host(xd), dtype, nnz_per_row=nnz_per_row,
        scale=scale,
    )

    print("PASSED!" if passed else "FAILED!")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
