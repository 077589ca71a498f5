"""Distributed SpMV benchmark over a device mesh.

Port of ``cfs_spmv_tpu/cli/bench_dist.py``, the scaling harness for
BASELINE configs 4/5 (row-partitioned SpMV, weak/strong scaling): runs
``DistSpDMV`` on 1, 2, 4, ... shards up to ``--devices`` and reports
preprocessing seconds, per-iteration time, nnz/s, the far fraction and
the parallel efficiency.

Usage: python -m cfs_spmv_tpu_torch.cli.bench_dist <file.mtx | --gen NAME>
       <iters> [--devices N] [--weak] [--model] [--rhs B] [--rate R]
       [--json FILE] [--device cuda|cuda:I|cpu]

``--device`` (default ``cuda``) names where the shards live:
``cuda`` puts one shard on each of the node's cards (``--devices``
defaults to all of them), ``cuda:0`` puts all of a sweep's shards on card
0 (``--devices 4`` sweeps 1, 2 and 4 shards there, every exchange a copy
within the card), and ``cpu`` runs the kernels' plain twins. A mesh on one
card is timed as ``utils/timing.time_matvec`` times it, one CUDA graph of
the applies; over several cards the operator replays its own graph of an
apply (``DistSpDMV.capturable`` is False), which a graph of the applies
cannot nest, so it is timed by the eager CUDA-event loop
(``time_matvec(graph=False)``) and its line says ``timer: eager``.

``--weak`` replicates the matrix block-diagonally per shard (weak
scaling: constant work per shard) instead of splitting it (strong).
``--model`` additionally prints the far-fraction-vs-devices profile and
the overlap-model efficiency built from the measured single-shard rate
(``parallel/scaling.py``, with the link table of the card
``utils/roofline.detect_chip`` names), halo and ring rows; ``--rate``
gives that model another compute base (nnz/s). ``--gen NAME`` generates
a BASELINE-scale proxy structure instead of reading a file: ``queen``
(4.15M rows banded), ``nlpkkt`` (8.37M-row stencil), ``audikw`` (943,695
rows scattered), or the small ``cant``/``general``/``band`` shapes
(``utils/proxies.py``). ``--json FILE`` appends one JSON line per run.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _block_diag_replicate(csr, k: int):
    """k copies of A on the diagonal (weak-scaling workload)."""
    from ..formats.coo import COO
    from ..formats.csr import CSR

    coo = csr.to_coo()
    n = csr.nrows
    r = np.concatenate([coo.row.astype(np.int64) + i * n for i in range(k)])
    c = np.concatenate([coo.col.astype(np.int64) + i * n for i in range(k)])
    v = np.tile(coo.val, k)
    return CSR.from_coo(
        COO(n * k, csr.ncols * k, r, c, v, csr.symmetric)
    )


def _opt(rest, name, cast, default):
    return cast(rest[rest.index(name) + 1]) if name in rest else default


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(
            "Usage: python -m cfs_spmv_tpu_torch.cli.bench_dist <mmf_file> "
            "<iters> [--devices N] [--weak] [--model] [--rhs B] "
            "[--device cuda|cuda:I|cpu]",
            file=sys.stderr,
        )
        return 1
    import torch

    from .. import Format, SparseMatrix
    from ..parallel.dist import DistSpDMV
    from ..parallel.mesh import get_devices, make_mesh
    from ..utils.timing import time_matvec

    if argv[0] == "--gen":
        from ..utils.proxies import GENERATORS

        name = argv[1]
        if name not in GENERATORS:
            raise SystemExit(
                f"unknown --gen {name!r}; one of {sorted(GENERATORS)}"
            )
        gen, gkw = GENERATORS[name]
        mmf_file, loops = None, int(argv[2])
        rest = argv[3:]
    else:
        mmf_file, loops = argv[0], int(argv[1])
        rest = argv[2:]
    device = _opt(rest, "--device", str, "cuda")
    ndev_max = _opt(rest, "--devices", int, None)
    if ndev_max is None:
        ndev_max = len(get_devices(None, device))
    weak = "--weak" in rest
    rhs = _opt(rest, "--rhs", int, 0)
    #: external compute base for the scaling model (nnz/s), e.g. the
    #: tuned single-card rate on a shard-sized slice of the structure
    rate_base = _opt(rest, "--rate", float, None)
    json_file = _opt(rest, "--json", str, None)

    if mmf_file is None:
        t0 = time.perf_counter()
        csr0 = gen(**gkw)
        print(
            f"# --gen {name}: {csr0.nrows} rows, nnz(stored) {csr0.nnz} "
            f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr,
        )
        A = SparseMatrix.create(
            csr0, Format.SSS if csr0.symmetric else Format.CSR
        )
    else:
        A = SparseMatrix.create(mmf_file, Format.CSR)
    base = None
    rows = []
    ndev = 1
    while ndev <= ndev_max:
        csr = _block_diag_replicate(A.csr, ndev) if weak else A.csr
        mesh = make_mesh(ndev, device=device)
        t0 = time.perf_counter()
        dsp = DistSpDMV(csr, mesh)
        if dsp.device.type == "cuda":
            torch.cuda.synchronize()
        preproc = time.perf_counter() - t0
        graphed = dsp.capturable
        x = np.random.default_rng(0).uniform(
            0.01, 0.42, csr.ncols
        ).astype(np.float32)
        t_iter = time_matvec(dsp, x, iters=loops, graph=graphed)
        nnz = dsp.nnz_full
        if base is None:
            base = t_iter
        eff = (
            base / t_iter if weak  # weak: flat time = 100%
            else base / (t_iter * ndev)  # strong: linear speedup = 100%
        )
        rows.append((ndev, preproc, t_iter, nnz / t_iter, eff))
        timer = "" if graphed else " timer: eager"
        print(
            f"devices: {ndev} preproc(sec): {preproc:.4g} "
            f"t(sec): {t_iter:.4g} nnz/s: {nnz / t_iter:.4g} "
            f"far: {100 * dsp.far_fraction:.2f}% "
            f"efficiency: {100 * eff:.0f}% comm: {dsp.comm} "
            f"halo_rows: {dsp.halo_rows}{timer}"
        )
        if rhs:
            X = np.random.default_rng(1).uniform(
                0.01, 0.42, (csr.ncols, rhs)
            ).astype(np.float32)
            t_mm = time_matvec(dsp, X, iters=max(loops // 4, 10),
                               graph=graphed)
            print(
                f"devices: {ndev} SpMM({rhs}): t(sec): {t_mm:.4g} "
                f"({t_mm / rhs:.4g}/RHS, {t_mm / t_iter:.1f}x SpMV)"
                f"{timer}"
            )
        ndev *= 2

    if json_file:
        import json

        with open(json_file, "a") as f:
            f.write(json.dumps(dict(
                structure=(name if mmf_file is None else mmf_file),
                nrows=int(A.nrows), nnz_stored=int(A.csr.nnz),
                device=device,
                ndev=[r[0] for r in rows],
                preproc_s=[r[1] for r in rows],
                nnz_s=[r[3] for r in rows],
            )) + "\n")

    if "--model" in rest:
        from ..parallel.scaling import scaling_model
        from ..utils.roofline import detect_chip

        chip = "cpu" if device == "cpu" else detect_chip().name
        nnz_s = rate_base or rows[0][3]  # compute base for the model
        print(
            f"# scaling model (chip={chip}, "
            f"{'shard-scale tuned base' if rate_base else 'measured'} "
            f"{nnz_s:.3g} nnz/s)"
        )
        profiles = {}  # far_profile is O(nnz) host work: share across modes
        for comm in ("auto", "ring"):
            for mode in ("weak", "strong"):
                for m in scaling_model(
                    A.csr, measured_nnz_s=nnz_s, chip=chip, mode=mode,
                    comm=comm, profiles=profiles,
                ):
                    print(
                        f"model {mode} comm={m['comm']} devices: "
                        f"{m['ndev']} hosts: {m['hosts']} ({m['link']}) "
                        f"far: {100 * m['far_fraction']:.2f}% "
                        f"comm_bytes: {m['comm_bytes']} t_compute: "
                        f"{m['t_compute_s']:.3g}s t_comm: "
                        f"{m['t_comm_s']:.3g}s "
                        f"efficiency: {100 * m['efficiency']:.0f}%"
                    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
