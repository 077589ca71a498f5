#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cfs_spmv_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases:

1. card name and power limit (``nvidia-smi``), PyTorch and CUDA versions;
2. build the CUDA kernels from ``cfs_spmv_tpu_torch/csrc/spmv_kernels.cu``;
3. the main path, once, through the user entry points —
   ``SparseMatrix.create(csr, Format.SSS)`` then
   ``SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32, device="cuda")(x)`` —
   on three full-size matrices (``cant_proxy()``, ``audikw_proxy()`` and
   the 65,536-row flagship), each checked against the float64 host
   oracle; the kernels' launch counts are zeroed just before and read
   just after, and each matrix must launch exactly the kernels its plan
   predicts;
4. each kernel against its plain PyTorch twin on the same card, on the
   real plan arrays of those matrices;
5. times per call (CUDA events around 20 back-to-back calls, median of
   5) of each kernel and twin, and of the kernel path and the plain path
   of every matrix.

It needs one card and imports nothing of JAX. Any failure raises, and the
exit code is then nonzero; without CUDA it exits 1 at once. The last two
lines of standard output are one JSON object per line: the kernels, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: launches each main-path matrix makes, by kernel wrapper (the plans'
#: streams: SDIA only; degree-grouped far stream; SDIA + sparse far)
EXPECTED = {
    "cant_proxy": {"sdia_sym"},
    "audikw_proxy": {"bell2_spmv", "unperm_gather"},
    "flagship": {"sdia_sym", "bell2_spmv_accum"},
}
TIMED_CALLS = 20


def flagship(n=1024, deg=8, dtype=np.float32, seed=0):
    """Banded symmetric matrix dense enough that tuning engages the SDIA
    stream, plus a scattered residual for the far path (the repository's
    flagship, ``__graft_entry__._flagship``, on the port's COO/CSR)."""
    from cfs_spmv_tpu_torch import COO, CSR

    rng = np.random.default_rng(seed)
    half_bw = max(2, deg // 2)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    scat = COO.random(n, n, 1.0, symmetric=True, seed=seed + 1,
                      dtype=dtype)
    r = np.concatenate([rows[keep], scat.row, np.arange(n)])
    c = np.concatenate([cols[keep], scat.col, np.arange(n)])
    v = np.concatenate([
        rng.uniform(-1, 1, keep.sum()),
        np.asarray(scat.val, np.float64),
        rng.uniform(1, 2, n),
    ]).astype(dtype)
    coo = COO(n, n, r, c, v, symmetric=True).canonicalize()
    return CSR.from_coo(coo)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _median_ms(torch, fn, calls=TIMED_CALLS, repeats=5):
    """Milliseconds per call: CUDA events around ``calls`` back-to-back
    calls, divided by the count; the median of ``repeats`` such runs,
    after one warm-up call. Operands stay in the 50 MB L2 across calls
    where they fit, as in a solver loop."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return float(np.median(per_call))


def _nbytes(*tensors):
    """Bytes the tensors occupy: what a kernel must at least move."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _agree(y, y_ref, scale, nnz_per_row, what):
    """allclose_spmv on card results; returns max |y - y_ref|."""
    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

    y, y_ref = y.double().cpu().numpy(), y_ref.double().cpu().numpy()
    scale = scale.double().cpu().numpy()
    if not (np.isfinite(y).all() and y.shape == y_ref.shape):
        raise AssertionError(f"{what}: non-finite or misshapen result")
    if not allclose_spmv(y, y_ref, np.float32, nnz_per_row=nnz_per_row,
                         scale=scale):
        raise AssertionError(
            f"{what}: disagrees (max abs err {np.abs(y - y_ref).max()})"
        )
    return float(np.abs(y - y_ref).max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cfs_spmv_tpu_torch import Format, SparseMatrix, SpDMV, Tuning
    from cfs_spmv_tpu_torch.ops import _cuda
    from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
    from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
    from cfs_spmv_tpu_torch.ops import spmv as ops
    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
    from cfs_spmv_tpu_torch.utils.proxies import audikw_proxy, cant_proxy

    wrappers = {
        "sdia_sym": sk.sdia_sym_tiles,
        "bell2_spmv": bk.bell2_spmv_tiles,
        "bell2_spmv_accum": bk.bell2_spmv_tiles_accum,
        "unperm_gather": bk.unperm_gather_tiles,
    }

    # -- 1. the card ----------------------------------------------------
    card = _card()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    mats = {
        "cant_proxy": cant_proxy(),
        "audikw_proxy": audikw_proxy(),
        "flagship": flagship(n=65536, deg=32),
    }
    print(f"matrices generated in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 3. the main path, once ----------------------------------------
    for w in wrappers.values():
        w.launches = 0
    runs = {}
    for name, csr in mats.items():
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        A = SparseMatrix.create(csr, Format.SSS)
        op = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32, device="cuda")
        t_tune = time.perf_counter() - t0
        x = np.random.default_rng(1).uniform(1.0, 2.0, csr.nrows).astype(
            np.float32
        )
        y = op(x)
        torch.cuda.synchronize()
        moved = {k for k, w in wrappers.items() if w.launches > before[k]}
        y_np = y.cpu().numpy()
        xd = x.astype(np.float64)
        ref = csr.spmv_host(xd)
        ok = (
            y_np.shape == (csr.nrows,) and np.isfinite(y_np).all()
            and allclose_spmv(
                y_np, ref, np.float32,
                nnz_per_row=A.tuned.nnz_full / csr.nrows,
                scale=csr.spmv_host(xd, absolute=True),
            )
        )
        plan = A.tuned.plan
        print(
            f"main path {name}: n={csr.nrows} nnz_full={A.tuned.nnz_full} "
            f"tune+upload {t_tune:.2f} s reorder={A.tuned.perm is not None} "
            f"dia={0 if plan.dia is None else len(plan.dia.offsets)} "
            f"far_nnz={0 if plan.far is None else plan.far.nnz} "
            f"far_chunks={0 if plan.far is None else plan.far.num_chunks} "
            f"kernels={sorted(moved)} max_abs_err="
            f"{float(np.abs(y_np - ref).max())} oracle_ok={ok}",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{name}: disagrees with the f64 oracle")
        if moved != EXPECTED[name]:
            raise AssertionError(
                f"{name}: launched {sorted(moved)}, expected "
                f"{sorted(EXPECTED[name])}"
            )
        runs[name] = (A, x)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"launch counts of the main path: {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError("a kernel of the path was never launched")

    # -- 4. each kernel against its plain twin, on the real plan arrays --
    def operands(name):
        A, x = runs[name]
        _, d = A.tuned.pure_apply()
        xe = A.tuned.encode(torch.as_tensor(x, device=dev))
        return A, d, xe

    g = torch.Generator(device="cpu").manual_seed(7)
    kern = {}

    # B1 on cant_proxy: the SDIA stream, onto a nonzero incoming y
    A, d, xe = operands("cant_proxy")
    x2d = ops.pad_x(xe, d.x_rows)
    y0 = torch.rand((d.num_row_tiles, 128), generator=g).to(dev)
    args = (d.dia_vals, x2d)
    yk = sk.sdia_sym_tiles(*args, y0.clone(), d.dia_offsets)
    yp = sk.sdia_sym_tiles_plain(*args, y0.clone(), d.dia_offsets)
    scale = sk.sdia_sym_tiles_plain(
        d.dia_vals.abs().double(), x2d.abs().double(), y0.abs().double(),
        d.dia_offsets,
    )
    err = _agree(yk, yp, scale, 2 * d.dia_vals.shape[1], "sdia_sym")
    kern["sdia_sym"] = dict(
        err=err,
        bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0),
        ms=_median_ms(torch, lambda: sk.sdia_sym_tiles(
            *args, y0.clone(), d.dia_offsets)),
        plain_ms=_median_ms(torch, lambda: sk.sdia_sym_tiles_plain(
            *args, y0.clone(), d.dia_offsets)),
    )

    # B2 + B3 on audikw_proxy: the degree-grouped far stream
    A, d, xe = operands("audikw_proxy")
    fd = d.far
    x2d = ops.pad_x(xe, d.x_rows)
    kw = dict(num_row_tiles=fd.num_row_tiles,
              chunks_per_step=fd.chunks_per_step,
              tiles_per_block=fd.tiles_per_block, contig=fd.contig)
    sargs = (fd.vals, fd.packed, fd.meta, fd.step_block, x2d)
    fk = bk.bell2_spmv_tiles(*sargs, **kw)
    fp = bk.bell2_spmv_tiles_plain(*sargs, **kw)
    fs = bk.bell2_spmv_tiles_plain(
        fd.vals.abs(), fd.packed, fd.meta, fd.step_block, x2d.abs(), **kw
    )
    BT = fd.tiles_per_block
    rows = (torch.unique(fd.step_block).long()[:, None] * BT
            + torch.arange(BT, device=dev)[None, :]).reshape(-1)
    rows = rows[rows < fd.num_row_tiles]  # the visited blocks' rows
    err = _agree(fk[rows], fp[rows], fs[rows],
                 A.tuned.plan.far.nnz / A.nrows, "bell2_spmv")
    kern["bell2_spmv"] = dict(
        err=err,
        bytes=_nbytes(*sargs[:4]) + _nbytes(fp),
        ms=_median_ms(torch, lambda: bk.bell2_spmv_tiles(*sargs, **kw)),
        plain_ms=_median_ms(
            torch, lambda: bk.bell2_spmv_tiles_plain(*sargs, **kw)),
    )
    uargs = (fd.unperm_pk, fd.unperm_slabs, fp[: fd.num_row_tiles])
    uk = bk.unperm_gather_tiles(*uargs)
    up = bk.unperm_gather_tiles_plain(*uargs)
    if not torch.equal(uk, up):
        raise AssertionError("unperm_gather: not bit-identical to its twin")
    kern["unperm_gather"] = dict(
        err=float((uk - up).abs().max()),
        bytes=_nbytes(fd.unperm_pk, uk) + 4 * A.nrows,
        ms=_median_ms(torch, lambda: bk.unperm_gather_tiles(*uargs)),
        plain_ms=_median_ms(
            torch, lambda: bk.unperm_gather_tiles_plain(*uargs)),
    )

    # B4 on the flagship: the sparse far residual, onto a nonzero y
    A, d, xe = operands("flagship")
    fd = d.far
    x2d = ops.pad_x(xe, d.x_rows)
    kw = dict(num_row_tiles=fd.num_row_tiles,
              chunks_per_step=fd.chunks_per_step,
              tiles_per_block=fd.tiles_per_block, contig=fd.contig)
    sargs = (fd.vals, fd.packed, fd.meta, fd.step_block, x2d)
    TP = -(-fd.num_row_tiles // fd.tiles_per_block) * fd.tiles_per_block
    y0 = torch.rand((TP, 128), generator=g).to(dev)
    yk = bk.bell2_spmv_tiles_accum(*sargs, y0.clone(), **kw)
    yp = bk.bell2_spmv_tiles_accum_plain(*sargs, y0.clone(), **kw)
    ys = bk.bell2_spmv_tiles_accum_plain(
        fd.vals.abs(), fd.packed, fd.meta, fd.step_block, x2d.abs(),
        y0.abs(), **kw
    )
    err = _agree(yk, yp, ys, A.tuned.plan.far.nnz / A.nrows,
                 "bell2_spmv_accum")
    kern["bell2_spmv_accum"] = dict(
        err=err,
        bytes=_nbytes(*sargs[:4]) + 2 * _nbytes(y0),
        ms=_median_ms(torch, lambda: bk.bell2_spmv_tiles_accum(
            *sargs, y0.clone(), **kw)),
        plain_ms=_median_ms(torch, lambda: bk.bell2_spmv_tiles_accum_plain(
            *sargs, y0.clone(), **kw)),
    )
    for name, k in kern.items():
        print(f"kernel {name}: max_abs_err vs twin {k['err']} "
              f"kernel {k['ms']:.4f} ms twin {k['plain_ms']:.4f} ms; "
              f"{k['bytes'] / 1e6:.2f} MB of operands -> "
              f"{k['bytes'] / k['ms'] / 1e6:.0f} GB/s by the kernel "
              f"({card})", flush=True)

    # -- 5. end to end: kernel path against plain path ---------------------
    for name in mats:
        A, d, xe = operands(name)
        yk = ops.sbell_apply(d, xe)
        yp = ops.sbell_apply(d, xe, plain=True)
        csr = mats[name]
        e2e_err = float((yk - yp).abs().max())
        ms_k = _median_ms(torch, lambda: ops.sbell_apply(d, xe))
        ms_p = _median_ms(torch, lambda: ops.sbell_apply(d, xe, plain=True))
        nnz = A.tuned.nnz_full
        print(
            f"end to end {name}: kernel path {ms_k:.4f} ms "
            f"({nnz / ms_k / 1e6:.2f} Gnnz/s), plain path {ms_p:.4f} ms "
            f"({nnz / ms_p / 1e6:.2f} Gnnz/s), max |kernel - plain| "
            f"{e2e_err}, n={csr.nrows} nnz_full={nnz} ({card})",
            flush=True,
        )

    sources = {
        "sdia_sym": "cfs_spmv_tpu/ops/sdia_kernel.py:157",
        "bell2_spmv": "cfs_spmv_tpu/ops/bell2_kernel.py:812",
        "bell2_spmv_accum": "cfs_spmv_tpu/ops/bell2_kernel.py:939",
        "unperm_gather": "cfs_spmv_tpu/ops/bell2_kernel.py:1216",
    }
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "cfs_spmv_tpu_torch/csrc/spmv_kernels.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": kern[name]["err"],
            "ms": kern[name]["ms"],
            "plain_ms": kern[name]["plain_ms"],
        }
        for name in wrappers
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
