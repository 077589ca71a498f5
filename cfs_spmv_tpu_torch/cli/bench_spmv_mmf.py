"""Throughput benchmark harness (ref ``bench/bench_spmv_mmf.cpp``).

Port of ``cfs_spmv_tpu/cli/bench_spmv_mmf.py``. Reports the reference's
line — preprocessing seconds (SpDMV construction, ref ``:145-148``),
per-iteration seconds (``utils/timing.time_matvec``: a CUDA graph of the
applies on the card), GFLOP/s = 2*nnz*iters/t (ref ``:168``) and stream
size in MB — plus the roofline tail: nnz/s against the card's speed of
light (``utils/roofline``).

Usage: python -m cfs_spmv_tpu_torch.cli.bench_spmv_mmf <file.mtx> <fmt>
       <iters> [--dp] [--rhs B] [--device cuda|cpu]

``--rhs B`` benchmarks SpDMM with B right-hand sides instead of SpDMV.
``--device`` defaults to ``cuda`` and raises where CUDA is absent.

Rival backends (the reference benches MKL-CSR as code 3 and librsb as
code 4, ``bench_spmv_mmf.cpp:179-300``): code 3 = ``TORCH_CSR`` runs
``torch.sparse_csr_tensor(A) @ x`` (cuSPARSE on the card); code 4 =
``DENSE`` runs a dense matmul. A rival is a yardstick, timed here only.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import parse_format

RIVALS = {"3": "TORCH_CSR", "4": "DENSE"}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(
            "Usage: python -m cfs_spmv_tpu_torch.cli.bench_spmv_mmf "
            "<mmf_file> <format: 0=csr 1=sss 2=hyb> <iters> [--dp] "
            "[--rhs B] [--device cuda|cpu]",
            file=sys.stderr,
        )
        return 1
    import torch

    from .. import SparseMatrix, SpDMV
    from ..ops.spmv import as_device
    from ..utils import roofline
    from ..utils.platform import Format, Tuning
    from ..utils.timing import time_matvec

    rival = RIVALS.get(
        argv[1], argv[1].upper() if argv[1].upper() in RIVALS.values()
        else None
    )
    mmf_file = argv[0]
    fmt = None if rival else parse_format(argv[1])
    loops = int(argv[2])
    rest = argv[3:]
    dtype = np.float64 if "--dp" in rest else np.float32
    rhs = int(rest[rest.index("--rhs") + 1]) if "--rhs" in rest else 0
    device = as_device(
        rest[rest.index("--device") + 1] if "--device" in rest else "cuda")

    A = SparseMatrix.create(mmf_file, Format.CSR if rival else fmt)
    M, N = A.nrows, A.ncols

    t0 = time.perf_counter()
    if rival:
        fn = _rival_fn(A, rival, dtype, device)
    else:
        fn = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    preproc = time.perf_counter() - t0

    rng = np.random.default_rng()
    shape = (N, rhs) if rhs else (N,)
    x = rng.uniform(0.01, 0.42, shape).astype(dtype)  # ref :125

    t_iter = time_matvec(fn, x, iters=loops)
    nnz_full = A.nnz_full if rival else A.tuned.nnz_full
    flops_per_apply = 2 * nnz_full * max(rhs, 1)
    gflops = flops_per_apply / t_iter / 1e9
    nnz_s = nnz_full / t_iter

    chip = roofline.detect_chip()
    bpn = roofline.spmv_bytes_per_nnz(
        value_bytes=np.dtype(dtype).itemsize, index_bytes=4,
        nnz=nnz_full, nrows=M, ncols=N,
        vector_bytes=np.dtype(dtype).itemsize,
    )
    sol = roofline.speed_of_light_nnz_s(chip, bpn)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1

    # reference-format line (bench_spmv_mmf.cpp:169-173) + roofline tail
    print(
        f"matrix: {os.path.basename(mmf_file)} "
        f"format: {rival or fmt.name}"
        f"{f'-MM{rhs}' if rhs else ''} "
        f"preproc(sec): {preproc:.4g} t(sec): {t_iter:.4g} "
        f"gflops/s: {gflops:.4g} devices: {devices} "
        f"size(MB): {A.size() / (1024 * 1024):.4g} "
        f"nnz/s: {nnz_s:.4g} roofline: {100 * nnz_s / sol:.0f}%"
    )
    return 0


class _Rival:
    """Rival backend wrapper speaking the pure-apply protocol, with the
    type and device of its vectors (``utils/timing.operator_space``)."""

    def __init__(self, fn, operands, dtype, device):
        self._fn = fn
        self._operands = operands
        self.dtype = dtype
        self.device = device

    def pure_apply(self):
        return self._fn, self._operands

    pure_apply_mm = pure_apply

    @staticmethod
    def encode(x):
        return x

    @staticmethod
    def decode(y):
        return y

    def __call__(self, x):
        return self._fn(self._operands, x)


def _rival_fn(A, rival: str, dtype, device) -> _Rival:
    """Stock-PyTorch baselines standing in for the reference's MKL/librsb
    rivals (``bench_spmv_mmf.cpp:179-300``)."""
    import torch

    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    coo = A.csr.to_coo()
    if A.csr.symmetric:
        coo = coo.expand_symmetric()
    if rival == "TORCH_CSR":
        from ..formats.csr import CSR

        csr = CSR.from_coo(coo)
        mat = torch.sparse_csr_tensor(
            torch.as_tensor(np.asarray(csr.indptr, np.int64)),
            torch.as_tensor(np.asarray(csr.indices, np.int64)),
            torch.as_tensor(np.asarray(csr.data), dtype=tdtype),
            size=(A.nrows, A.ncols),
        ).to(device)
        return _Rival(lambda m, x: m @ x, mat, tdtype, device)
    if rival == "DENSE":
        if A.nrows * A.ncols > 64_000_000:
            raise SystemExit(
                "DENSE rival limited to matrices under 64M cells"
            )
        d = torch.as_tensor(coo.to_dense(), dtype=tdtype).to(device)
        return _Rival(lambda m, x: m @ x, d, tdtype, device)
    raise SystemExit(f"unknown rival backend {rival!r}")


if __name__ == "__main__":
    sys.exit(main())
