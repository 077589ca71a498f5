#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cfs_spmv_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints its wall time):

1. card name and power limit (``nvidia-smi``), PyTorch and CUDA versions;
2. build the CUDA kernels from ``cfs_spmv_tpu_torch/csrc/spmv_kernels.cu``;
3. the main paths, once each, through the user entry points —
   ``SparseMatrix.create(csr, fmt)`` then
   ``SpDMV(A, tuning, dtype=np.float32, device="cuda")(x)`` and
   ``SpDMM(A, tuning, dtype=np.float32, device="cuda")(X)`` with X of
   B = 8 columns (SpMM, ROADMAP A7) — on nine
   full-size runs (``RUNS``): the tuned symmetric path on
   ``cant_proxy()``, ``audikw_proxy()`` and the 65,536-row flagship; the
   general path on ``general_asym()`` and on the flagship as a general
   matrix; the untuned oracle path (``Tuning.NONE``) on
   ``cant_proxy()``; the paired stream on ``near_band_paired()`` with
   ``CFS_PAIRED=force``, and the same matrix under the default
   ``CFS_PAIRED=auto`` gate (which routes it to the one-sided stream);
   mirrored diagonals on ``cant_proxy()`` with ``SDIA_SYM_ROWS_MAX``
   below its size. Each result (each column of Y) is checked against
   the float64 host oracle. The kernels' launch counts are zeroed just
   before each apply and read just after; each SpMV apply must launch
   exactly the kernels its plan predicts (and ``EXPECTED`` lists), each
   SpMM apply exactly their multi-RHS forms (``EXPECTED_MM``) and no
   SpMV kernel;
4. each kernel against its plain PyTorch twin on the same card, on the
   real plan arrays of those runs (``sbell_spmv`` also replanned with the
   other transpose-window count and with 8-tile output blocks,
   ``sdia_gen`` also on a ragged ``general_asym(g=50)`` plan); each
   multi-RHS kernel at B = 8 and at B = 11 (two plane groups), into
   NaN-poisoned outputs where the kernel zeroes its own, ``sbell_spmm``
   also on the 8-tile-block replan, ``unperm_gather_mm`` bit-identical;
5. times per call (CUDA events around 20 back-to-back calls, median of
   5) of each kernel and twin (multi-RHS ones at B = 8), and of the
   kernel path and the plain path of every run, SpMV and SpMM(8), with
   the device time of each apply and of each kernel from
   ``torch.profiler``; for ``bell2_spmm``, ``sbell_spmm`` and
   ``sdia_sym_mm`` the MM(8) kernel's device time beside 8x its SpMV
   form's on the same plan, and for every run the SpMM(8) apply beside
   8 SpMV applies;
6. the differential CLI (``cfs_spmv_tpu_torch.cli.test_spmv_mmf``) on a
   written ``.mtx`` with ``--device cuda``; it must print ``PASSED!``.

It needs one card and imports nothing of JAX. Any failure raises, and the
exit code is then nonzero; without CUDA it exits 1 at once. The last two
lines of standard output are one JSON object per line: the kernels, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

#: kernels each main-path run launches (its plan's streams)
EXPECTED = {
    "cant_proxy": {"sdia_sym"},  # SDIA only
    "audikw_proxy": {"bell2_spmv", "unperm_gather"},  # grouped far stream
    "flagship": {"sdia_sym", "bell2_spmv_accum"},  # SDIA + sparse far
    "general_asym": {"sdia_gen"},  # signed peel, no residual
    "flagship_csr": {"sdia_gen", "bell2_spmv_accum"},  # peel + residual
    "cant_proxy_none": {"bell2_spmv"},  # the untuned oracle stream
    "near_band_paired": {"sbell_spmv", "bell2_spmv_accum"},  # paired + far
    # the default gate's choice for the same matrix: grouped one-sided
    "near_band_paired_auto": {"bell2_spmv", "unperm_gather"},
    "cant_proxy_mirrored": {"sdia_gen"},  # mirrored diagonals
}
#: the multi-RHS form of each kernel: an SpMM apply runs the same
#: branches as the SpMV apply of its plan, through these
MM_OF = {
    "sdia_sym": "sdia_sym_mm",
    "bell2_spmv": "bell2_spmm",
    "bell2_spmv_accum": "bell2_spmm_accum",
    "unperm_gather": "unperm_gather_mm",
    "sbell_spmv": "sbell_spmm",
    "sdia_gen": "sdia_gen_mm",
}
#: kernels each main-path run's SpMM(8) apply launches (no SpMV kernel)
EXPECTED_MM = {
    "cant_proxy": {"sdia_sym_mm"},
    "audikw_proxy": {"bell2_spmm", "unperm_gather_mm"},
    "flagship": {"sdia_sym_mm", "bell2_spmm_accum"},
    "general_asym": {"sdia_gen_mm"},
    "flagship_csr": {"sdia_gen_mm", "bell2_spmm_accum"},
    "cant_proxy_none": {"bell2_spmm"},
    "near_band_paired": {"sbell_spmm", "bell2_spmm_accum"},
    "near_band_paired_auto": {"bell2_spmm", "unperm_gather_mm"},
    "cant_proxy_mirrored": {"sdia_gen_mm"},
}
#: the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "sdia_sym": "cfs_spmv_tpu/ops/sdia_kernel.py:157",
    "bell2_spmv": "cfs_spmv_tpu/ops/bell2_kernel.py:812",
    "bell2_spmv_accum": "cfs_spmv_tpu/ops/bell2_kernel.py:939",
    "unperm_gather": "cfs_spmv_tpu/ops/bell2_kernel.py:1216",
    "sbell_spmv": "cfs_spmv_tpu/ops/bell2_kernel.py:1385",
    "sdia_gen": "cfs_spmv_tpu/ops/sdia_kernel.py:251",
    "bell2_spmm": "cfs_spmv_tpu/ops/bell2_kernel.py:1084",
    "bell2_spmm_accum": "cfs_spmv_tpu/ops/bell2_kernel.py:1562",
    "unperm_gather_mm": "cfs_spmv_tpu/ops/bell2_kernel.py:1264",
    "sbell_spmm": "cfs_spmv_tpu/ops/bell2_kernel.py:1468",
    "sdia_sym_mm": "cfs_spmv_tpu/ops/sdia_kernel.py:391",
    "sdia_gen_mm": "cfs_spmv_tpu/ops/sdia_kernel.py:326",
}
TIMED_CALLS = 20
#: right-hand sides of the SpMM runs (the reference bench's SpMM(8))
RHS = 8


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


def _device_ms(torch, fn, calls=TIMED_CALLS):
    """(device busy ms per call, {kernel: ms per call}) from
    ``torch.profiler`` over ``calls`` back-to-back calls: the summed
    durations of the card's own events (kernels, copies, fills), so the
    wrappers' host overhead is not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # "void (anonymous namespace)::sbell_spmv_kernel<4>(...)"
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            name = name.replace("void ", "").strip()[:40]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.device_time_total / 1e3 / calls)
    return sum(by_name.values()), by_name


def _fmt_device(busy, by_name):
    if not by_name:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return f"device {busy:.4f} ms (" + ", ".join(
        f"{k} {v:.4f}" for k, v in top) + ")"


def _ratio(num, den):
    """num / den, or "not measured" where the profiler saw no device
    events for either."""
    return f"{num / den:.3f}" if num and den else "not measured"


def _nbytes(*tensors):
    """Bytes the tensors occupy: what a kernel must at least move."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _agree(y, y_ref, scale, nnz_per_row, what):
    """allclose_spmv on card results (any shape: an MM result is checked
    element by element, each plane being one SpMV's); returns max
    |y - y_ref|."""
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


@contextlib.contextmanager
def _planning(paired=None, sym_rows_max=None):
    """Planner settings of one run: ``CFS_PAIRED`` and the module-level
    ``SDIA_SYM_ROWS_MAX``, restored afterwards."""
    from cfs_spmv_tpu_torch.formats import sdia

    old_env, old_max = os.environ.get("CFS_PAIRED"), sdia.SDIA_SYM_ROWS_MAX
    if paired is not None:
        os.environ["CFS_PAIRED"] = paired
    if sym_rows_max is not None:
        sdia.SDIA_SYM_ROWS_MAX = sym_rows_max
    try:
        yield
    finally:
        sdia.SDIA_SYM_ROWS_MAX = old_max
        if old_env is None:
            os.environ.pop("CFS_PAIRED", None)
        else:
            os.environ["CFS_PAIRED"] = old_env


def predict(tuned) -> set:
    """The kernels an apply of ``tuned`` launches, read off its device
    struct (the branches of ``ops/spmv.bell2_apply`` / ``sbell_apply``)."""
    from cfs_spmv_tpu_torch.ops.spmv import Bell2Device

    dev = tuned.operands
    dev = dev["dev"] if isinstance(dev, dict) else dev
    out = set()
    if isinstance(dev, Bell2Device):
        if dev.has_work:
            sparse = dev.sparse_stream and not dev.grouped
            out.add("bell2_spmv_accum" if sparse else "bell2_spmv")
        if dev.grouped:
            out.add("unperm_gather")
        if dev.dia_vals is not None:
            out.add("sdia_gen")
        return out
    if dev.has_paired:
        out.add("sbell_spmv")
    if dev.far is not None:
        out |= ({"bell2_spmv", "unperm_gather"} if dev.far.grouped
                else {"bell2_spmv_accum"})
    if dev.dia_vals is not None:
        out.add("sdia_gen" if dev.dia_mirrored else "sdia_sym")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cfs_spmv_tpu_torch import Format, SparseMatrix, SpDMM, SpDMV, Tuning
    from cfs_spmv_tpu_torch.cli.test_spmv_mmf import main as test_cli
    from cfs_spmv_tpu_torch.formats.bell2 import build_general_plan
    from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
    from cfs_spmv_tpu_torch.io.mmf import write_mmf
    from cfs_spmv_tpu_torch.ops import _cuda
    from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
    from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
    from cfs_spmv_tpu_torch.ops import spmv as ops
    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
    from cfs_spmv_tpu_torch.utils.proxies import (
        audikw_proxy,
        cant_proxy,
        general_asym,
        near_band_paired,
    )

    wrappers = {
        "sdia_sym": sk.sdia_sym_tiles,
        "bell2_spmv": bk.bell2_spmv_tiles,
        "bell2_spmv_accum": bk.bell2_spmv_tiles_accum,
        "unperm_gather": bk.unperm_gather_tiles,
        "sbell_spmv": bk.sbell_spmv_tiles,
        "sdia_gen": sk.sdia_gen_tiles,
        "sdia_sym_mm": sk.sdia_sym_tiles_mm,
        "bell2_spmm": bk.bell2_spmm_tiles,
        "bell2_spmm_accum": bk.bell2_spmm_tiles_accum,
        "unperm_gather_mm": bk.unperm_gather_tiles_mm,
        "sbell_spmm": bk.sbell_spmm_tiles,
        "sdia_gen_mm": sk.sdia_gen_tiles_mm,
    }
    t_start = time.perf_counter()
    phase_t = [time.perf_counter()]

    def phase_done(what):
        now = time.perf_counter()
        print(f"phase {what}: {now - phase_t[0]:.2f} s", flush=True)
        phase_t[0] = now

    # -- 1. the card ----------------------------------------------------
    card = _card()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")
    phase_done("1 card")

    # -- 2. build -------------------------------------------------------
    _cuda.lib()
    phase_done("2 kernel build/load")

    t0 = time.perf_counter()
    cant = cant_proxy()
    flag = flagship(n=65536, deg=32)
    nbp = near_band_paired()
    #: name -> (CSR, format, tuning, CFS_PAIRED, SDIA_SYM_ROWS_MAX)
    RUNS = {
        "cant_proxy": (cant, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "audikw_proxy": (audikw_proxy(), Format.SSS, Tuning.AGGRESSIVE,
                         None, None),
        "flagship": (flag, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "general_asym": (general_asym(), Format.CSR, Tuning.AGGRESSIVE,
                         None, None),
        "flagship_csr": (flag, Format.CSR, Tuning.AGGRESSIVE, None, None),
        "cant_proxy_none": (cant, Format.SSS, Tuning.NONE, None, None),
        "near_band_paired": (nbp, Format.SSS, Tuning.AGGRESSIVE, "force",
                             None),
        "near_band_paired_auto": (nbp, Format.SSS, Tuning.AGGRESSIVE,
                                  "auto", None),
        "cant_proxy_mirrored": (cant, Format.SSS, Tuning.AGGRESSIVE, None,
                                cant.nrows - 1),
    }
    print(f"matrices generated in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 3. the main paths, once each -----------------------------------
    launches = dict.fromkeys(wrappers, 0)
    runs = {}
    for name, (csr, fmt, tuning, paired, rows_max) in RUNS.items():
        t0 = time.perf_counter()
        with _planning(paired, rows_max):
            A = SparseMatrix.create(csr, fmt)
            op = SpDMV(A, tuning, dtype=np.float32, device="cuda")
            op_mm = SpDMM(A, tuning, dtype=np.float32, device="cuda")
        t_tune = time.perf_counter() - t0
        predicted = predict(A.tuned)
        x = np.random.default_rng(1).uniform(1.0, 2.0, csr.ncols).astype(
            np.float32
        )
        for w in wrappers.values():
            w.launches = 0
        y = op(x)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        moved = {k for k, c in counts.items() if c}
        for k, c in counts.items():
            launches[k] += c
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
        far = getattr(plan, "far", None)
        print(
            f"main path {name}: n={csr.nrows} nnz_full={A.tuned.nnz_full} "
            f"{fmt.name}/{tuning.name} tune+upload {t_tune:.2f} s "
            f"reorder={A.tuned.perm is not None} "
            f"dia={None if plan.dia is None else len(plan.dia.offsets)} "
            f"paired_nnz={getattr(plan, 'nnz_paired', 0)} "
            f"tw={getattr(plan, 'transpose_windows', None)} "
            f"stream_nnz={getattr(plan, 'nnz', 0)} "
            f"far_nnz={0 if far is None else far.nnz} "
            f"predicted={sorted(predicted)} launched={counts} "
            f"max_abs_err={float(np.abs(y_np - ref).max())} "
            f"oracle_ok={ok}",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{name}: disagrees with the f64 oracle")
        if not moved == predicted == EXPECTED[name]:
            raise AssertionError(
                f"{name}: launched {sorted(moved)}, predicted "
                f"{sorted(predicted)}, expected {sorted(EXPECTED[name])}"
            )
        # SpMM(8) through SpDMM on the same tuned matrix
        X = np.random.default_rng(2).uniform(
            1.0, 2.0, (csr.ncols, RHS)).astype(np.float32)
        predicted_mm = {MM_OF[k] for k in predicted}
        for w in wrappers.values():
            w.launches = 0
        Y = op_mm(X)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        moved = {k for k, c in counts.items() if c}
        for k, c in counts.items():
            launches[k] += c
        Y_np = Y.cpu().numpy()
        errs, ok = [], Y_np.shape == (csr.nrows, RHS)
        for b in range(RHS):
            xd = X[:, b].astype(np.float64)
            ref = csr.spmv_host(xd)
            errs.append(float(np.abs(Y_np[:, b] - ref).max()))
            ok = ok and np.isfinite(Y_np[:, b]).all() and allclose_spmv(
                Y_np[:, b], ref, np.float32,
                nnz_per_row=A.tuned.nnz_full / csr.nrows,
                scale=csr.spmv_host(xd, absolute=True),
            )
        print(
            f"main path {name} SpMM({RHS}): predicted={sorted(predicted_mm)} "
            f"launched={ {k: c for k, c in counts.items() if c} } "
            f"max_abs_err={max(errs)} oracle_ok={ok}",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{name} SpMM: disagrees with the oracle")
        if not moved == predicted_mm == EXPECTED_MM[name]:
            raise AssertionError(
                f"{name} SpMM: launched {sorted(moved)}, predicted "
                f"{sorted(predicted_mm)}, expected "
                f"{sorted(EXPECTED_MM[name])} (no SpMV kernel may run)"
            )
        runs[name] = (A, x)
    print(f"launch counts of the main paths: {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError("a kernel of the paths was never launched")
    phase_done("3 main paths")

    # -- 4. each kernel against its plain twin, on the real plan arrays --
    def operands(name):
        A, x = runs[name]
        _, d = A.tuned.pure_apply()
        xe = A.tuned.encode(torch.as_tensor(x, device=dev))
        return A, d, xe

    g = torch.Generator(device="cpu").manual_seed(7)
    kern = {}

    def planes(B, rows, extra=0):
        """(B, rows, 128) random planes on the card; with ``extra``, a
        column slice of wider planes (plane stride past the plane)."""
        wide = torch.rand((B, rows + extra, 128), generator=g).to(dev)
        return wide[:, :rows]

    def mm_pair(key, make, nnz_per_row, on, rows=None, exact=False):
        """Check the multi-RHS kernel ``key`` against its twin at B = 11
        (two plane groups) and B = 8; keep the B = 8 closures for the
        timing. ``make(B)`` returns (check, fn, plain, scale, bytes):
        ``check()`` runs the kernel as the check wants it (NaN-poisoned
        output where it zeroes its own), ``scale()`` the twin on |.|."""
        errs = []
        for B in (11, RHS):
            check, fn, plain, scale, nbytes = make(B)
            yk, yp = check(), plain()
            torch.cuda.synchronize()
            sel = (lambda t: t) if rows is None else (lambda t: t[:, rows])
            if exact:
                if not torch.equal(yk, yp):
                    raise AssertionError(
                        f"{key} B={B}: not bit-identical to its twin")
                errs.append(0.0)
            else:
                errs.append(_agree(sel(yk), sel(yp), sel(scale()),
                                   nnz_per_row, f"{key} B={B}"))
            print(f"kernel {key} B={B} on {on}: max_abs_err vs twin "
                  f"{errs[-1]}", flush=True)
        # a kernel checked on several plans keeps its worst error
        errs.append(kern.get(key, {}).get("err", 0.0))
        kern[key] = dict(err=max(errs), on=f"{on}, B={RHS}", bytes=nbytes,
                         fn=fn, plain=plain)

    def poisoned(shape):
        return torch.full(shape, float("nan"), device=dev)

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
        err=err, on="cant_proxy",
        bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0),
        fn=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles(
            *a, y.clone(), o),
        plain=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles_plain(
            *a, y.clone(), o),
    )

    # B11 on cant_proxy: onto nonzero Y planes held at a plane stride
    # past the plane
    def make_sdia_sym_mm(B, d=d):
        x3 = planes(B, d.x_rows)
        y3 = planes(B, d.num_row_tiles, extra=3)
        a = (d.dia_vals, x3)
        o = d.dia_offsets
        return (lambda: sk.sdia_sym_tiles_mm(*a, y3.clone(), o),
                lambda: sk.sdia_sym_tiles_mm(*a, y3.clone(), o),
                lambda: sk.sdia_sym_tiles_mm_plain(*a, y3.clone(), o),
                lambda: sk.sdia_sym_tiles_mm_plain(
                    d.dia_vals.abs().double(), x3.abs().double(),
                    y3.abs().double(), o),
                _nbytes(d.dia_vals, x3) + 2 * _nbytes(y3))

    mm_pair("sdia_sym_mm", make_sdia_sym_mm, 2 * d.dia_vals.shape[1],
            "cant_proxy")

    # B2 + B3 on audikw_proxy: the degree-grouped far stream
    A, d, xe = operands("audikw_proxy")
    fd = d.far
    x2d_a = ops.pad_x(xe, d.x_rows)
    kw_a = fd.stream_kw()
    sargs_a = (fd.vals, fd.packed, fd.meta, fd.step_block, x2d_a)
    fk = bk.bell2_spmv_tiles(*sargs_a, **kw_a)
    fp = bk.bell2_spmv_tiles_plain(*sargs_a, **kw_a)
    fs = bk.bell2_spmv_tiles_plain(
        fd.vals.abs(), fd.packed, fd.meta, fd.step_block, x2d_a.abs(),
        **kw_a
    )
    BT = fd.tiles_per_block
    rows = (torch.unique(fd.step_block).long()[:, None] * BT
            + torch.arange(BT, device=dev)[None, :]).reshape(-1)
    rows = rows[rows < fd.num_row_tiles]  # the visited blocks' rows
    err = _agree(fk[rows], fp[rows], fs[rows],
                 A.tuned.plan.far.nnz / A.nrows, "bell2_spmv")
    kern["bell2_spmv"] = dict(
        err=err, on="audikw_proxy",
        bytes=_nbytes(*sargs_a[:4]) + _nbytes(fp),
        fn=lambda: bk.bell2_spmv_tiles(*sargs_a, **kw_a),
        plain=lambda: bk.bell2_spmv_tiles_plain(*sargs_a, **kw_a),
    )
    uargs = (fd.unperm_pk, fd.unperm_slabs, fp[: fd.num_row_tiles])
    uk = bk.unperm_gather_tiles(*uargs)
    up = bk.unperm_gather_tiles_plain(*uargs)
    if not torch.equal(uk, up):
        raise AssertionError("unperm_gather: not bit-identical to its twin")
    kern["unperm_gather"] = dict(
        err=float((uk - up).abs().max()), on="audikw_proxy",
        bytes=_nbytes(fd.unperm_pk, uk) + 4 * A.nrows,
        fn=lambda: bk.unperm_gather_tiles(*uargs),
        plain=lambda: bk.unperm_gather_tiles_plain(*uargs),
    )

    # B7 + B9 on audikw_proxy's grouped far stream: B7 into NaN-poisoned
    # planes (checked on the visited blocks' rows), B9 bit-identical
    TPa = -(-fd.num_row_tiles // BT) * BT

    def make_bell2_mm(B, fd=fd):
        sa = (fd.vals, fd.packed, fd.meta, fd.step_block, planes(B, fd.x_rows))
        return (lambda: bk.bell2_spmm_tiles(
                    *sa, out=poisoned((B, TPa, 128)), **kw_a),
                lambda: bk.bell2_spmm_tiles(*sa, **kw_a),
                lambda: bk.bell2_spmm_tiles_plain(*sa, **kw_a),
                lambda: bk.bell2_spmm_tiles_plain(
                    fd.vals.abs(), *sa[1:4], sa[4].abs(), **kw_a),
                _nbytes(*sa) + B * _nbytes(fp))

    mm_pair("bell2_spmm", make_bell2_mm, A.tuned.plan.far.nnz / A.nrows,
            "audikw_proxy", rows=rows)

    def make_unperm_mm(B, fd=fd):
        ua = (fd.unperm_pk, fd.unperm_slabs,
              planes(B, fd.num_row_tiles, extra=2))
        return (lambda: bk.unperm_gather_tiles_mm(*ua),
                lambda: bk.unperm_gather_tiles_mm(*ua),
                lambda: bk.unperm_gather_tiles_mm_plain(*ua),
                None, _nbytes(fd.unperm_pk) + 2 * B * _nbytes(uk))

    mm_pair("unperm_gather_mm", make_unperm_mm, 0, "audikw_proxy",
            exact=True)

    # B4 on the flagship: the sparse far residual, onto a nonzero y
    A, d, xe = operands("flagship")
    fd = d.far
    x2d_f = ops.pad_x(xe, d.x_rows)
    kw_f = fd.stream_kw()
    sargs_f = (fd.vals, fd.packed, fd.meta, fd.step_block, x2d_f)
    TP = -(-fd.num_row_tiles // fd.tiles_per_block) * fd.tiles_per_block
    y0_f = torch.rand((TP, 128), generator=g).to(dev)
    yk = bk.bell2_spmv_tiles_accum(*sargs_f, y0_f.clone(), **kw_f)
    yp = bk.bell2_spmv_tiles_accum_plain(*sargs_f, y0_f.clone(), **kw_f)
    ys = bk.bell2_spmv_tiles_accum_plain(
        fd.vals.abs(), fd.packed, fd.meta, fd.step_block, x2d_f.abs(),
        y0_f.abs(), **kw_f
    )
    err = _agree(yk, yp, ys, A.tuned.plan.far.nnz / A.nrows,
                 "bell2_spmv_accum")
    kern["bell2_spmv_accum"] = dict(
        err=err, on="flagship",
        bytes=_nbytes(*sargs_f[:4]) + 2 * _nbytes(y0_f),
        fn=lambda: bk.bell2_spmv_tiles_accum(*sargs_f, y0_f.clone(), **kw_f),
        plain=lambda: bk.bell2_spmv_tiles_accum_plain(
            *sargs_f, y0_f.clone(), **kw_f),
    )

    # B8 on the flagship's sparse far residual, onto nonzero Y planes
    def make_bell2_acc_mm(B, fd=fd, TP=TP):
        sa = (fd.vals, fd.packed, fd.meta, fd.step_block, planes(B, fd.x_rows))
        y3 = planes(B, TP)
        return (lambda: bk.bell2_spmm_tiles_accum(*sa, y3.clone(), **kw_f),
                lambda: bk.bell2_spmm_tiles_accum(*sa, y3.clone(), **kw_f),
                lambda: bk.bell2_spmm_tiles_accum_plain(
                    *sa, y3.clone(), **kw_f),
                lambda: bk.bell2_spmm_tiles_accum_plain(
                    fd.vals.abs(), *sa[1:4], sa[4].abs(), y3.abs(), **kw_f),
                _nbytes(*sa) + 2 * _nbytes(y3))

    mm_pair("bell2_spmm_accum", make_bell2_acc_mm,
            A.tuned.plan.far.nnz / A.nrows, "flagship")

    # B5 on near_band_paired: the paired stream of the main path, the
    # same matrix planned with the other transpose-window count, and with
    # 8-tile output blocks (the main plan has one block), each into a
    # NaN-poisoned buffer
    A, d, xe = operands("near_band_paired")
    other_tw = 2 if d.transpose_windows == 4 else 4
    with _planning("force"):
        variants = [
            ops.sym_to_device(build_sbell_plan(A.csr, **kw), dev)
            for kw in (dict(transpose_windows=other_tw),
                       dict(transpose_windows=d.transpose_windows,
                            tiles_per_block=8))
        ]
    errs = []
    for dp in variants + [d]:  # the main plan's last, for the timing
        kw_p = dict(num_row_tiles=dp.num_row_tiles,
                    chunks_per_step=dp.chunks_per_step,
                    tiles_per_block=dp.tiles_per_block,
                    transpose_windows=dp.transpose_windows)
        pargs = (dp.vals, dp.packed, dp.meta, dp.step_block,
                 ops.pad_x(xe, dp.x_rows))
        TP = -(-dp.num_row_tiles // dp.tiles_per_block) * dp.tiles_per_block
        poison = torch.full((TP, 128), float("nan"), device=dev)
        yk = bk.sbell_spmv_tiles(*pargs, out=poison, **kw_p)
        yp = bk.sbell_spmv_tiles_plain(*pargs, **kw_p)
        ys = bk.sbell_spmv_tiles_plain(
            dp.vals.abs(), *pargs[1:4], pargs[4].abs(), **kw_p)
        what = (f"sbell_spmv TW={dp.transpose_windows} "
                f"BT={dp.tiles_per_block}")
        errs.append(_agree(yk, yp, ys, 2 * A.tuned.nnz_full / A.nrows, what))
        print(f"kernel {what}: {dp.vals.shape[0] // 8} chunks in "
              f"{TP // dp.tiles_per_block} blocks, max_abs_err vs twin "
              f"{errs[-1]}", flush=True)
    kern["sbell_spmv"] = dict(
        err=max(errs), on=f"near_band_paired TW={d.transpose_windows}",
        bytes=_nbytes(*pargs) + _nbytes(yp),
        fn=lambda: bk.sbell_spmv_tiles(*pargs, **kw_p),
        plain=lambda: bk.sbell_spmv_tiles_plain(*pargs, **kw_p),
    )

    # B10 on the 8-tile-block replan (49 blocks), then on the main plan,
    # into NaN-poisoned planes
    for dp in (variants[1], d):
        TPp = -(-dp.num_row_tiles // dp.tiles_per_block) * dp.tiles_per_block
        kw_q = dict(num_row_tiles=dp.num_row_tiles,
                    chunks_per_step=dp.chunks_per_step,
                    tiles_per_block=dp.tiles_per_block,
                    transpose_windows=dp.transpose_windows)

        def make_sbell_mm(B, dp=dp, TPp=TPp, kw_q=kw_q):
            sa = (dp.vals, dp.packed, dp.meta, dp.step_block,
                  planes(B, dp.x_rows))
            return (lambda: bk.sbell_spmm_tiles(
                        *sa, out=poisoned((B, TPp, 128)), **kw_q),
                    lambda: bk.sbell_spmm_tiles(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(
                        dp.vals.abs(), *sa[1:4], sa[4].abs(), **kw_q),
                    _nbytes(*sa) + 4 * B * TPp * 128)

        mm_pair("sbell_spmm", make_sbell_mm, 2 * A.tuned.nnz_full / A.nrows,
                f"near_band_paired TW={dp.transpose_windows} "
                f"BT={dp.tiles_per_block} ({TPp // dp.tiles_per_block} "
                "blocks)")

    # B6 on a ragged general_asym(g=50) plan (125,000 rows: fewer x and
    # y rows than its padded value blocks hold) and on general_asym's
    # signed-offset peel, each onto a nonzero y
    A, d, xe = operands("general_asym")
    ragged = ops.to_device(build_general_plan(general_asym(g=50)), dev)
    x_r = torch.rand(ragged.ncols, generator=g).to(dev)
    errs = []
    for dg, xg in ((ragged, x_r), (d, xe)):  # the main plan's last
        x2d_g = ops.pad_x(xg, dg.x_rows)
        y0_g = torch.rand((dg.num_row_tiles, 128), generator=g).to(dev)
        gargs = (dg.dia_vals, x2d_g)
        yk = sk.sdia_gen_tiles(*gargs, y0_g.clone(), dg.dia_offsets)
        yp = sk.sdia_gen_tiles_plain(*gargs, y0_g.clone(), dg.dia_offsets)
        scale = sk.sdia_gen_tiles_plain(
            dg.dia_vals.abs().double(), x2d_g.abs().double(),
            y0_g.abs().double(), dg.dia_offsets,
        )
        what = (f"sdia_gen n={dg.nrows} rows of values "
                f"{dg.dia_vals.shape[0] * 1024} x rows {dg.x_rows * 128}")
        errs.append(_agree(yk, yp, scale, dg.dia_vals.shape[1], what))
        print(f"kernel {what}: max_abs_err vs twin {errs[-1]}", flush=True)
    kern["sdia_gen"] = dict(
        err=max(errs), on="general_asym",
        bytes=_nbytes(d.dia_vals, x2d_g) + 2 * _nbytes(y0_g),
        fn=lambda o=d.dia_offsets: sk.sdia_gen_tiles(
            *gargs, y0_g.clone(), o),
        plain=lambda o=d.dia_offsets: sk.sdia_gen_tiles_plain(
            *gargs, y0_g.clone(), o),
    )

    # B12 on the ragged plan, then on general_asym's peel, onto nonzero Y
    # planes held at a plane stride past the plane
    for dg, on in ((ragged, "general_asym(g=50)"), (d, "general_asym")):
        def make_sdia_gen_mm(B, dg=dg):
            x3 = planes(B, dg.x_rows)
            y3 = planes(B, dg.num_row_tiles, extra=3)
            a = (dg.dia_vals, x3)
            o = dg.dia_offsets
            return (lambda: sk.sdia_gen_tiles_mm(*a, y3.clone(), o),
                    lambda: sk.sdia_gen_tiles_mm(*a, y3.clone(), o),
                    lambda: sk.sdia_gen_tiles_mm_plain(*a, y3.clone(), o),
                    lambda: sk.sdia_gen_tiles_mm_plain(
                        dg.dia_vals.abs().double(), x3.abs().double(),
                        y3.abs().double(), o),
                    _nbytes(dg.dia_vals, x3) + 2 * _nbytes(y3))

        mm_pair("sdia_gen_mm", make_sdia_gen_mm, dg.dia_vals.shape[1], on)
    phase_done("4 kernels against twins")

    # -- 5. times: kernels, then the kernel path against the plain path --
    for name, k in kern.items():
        k["ms"] = _median_ms(torch, k["fn"])
        k["plain_ms"] = _median_ms(torch, k["plain"])
        busy, k["device"] = _device_ms(torch, k["fn"])
        print(f"kernel {name} on {k['on']}: max_abs_err vs twin {k['err']} "
              f"kernel {k['ms']:.4f} ms twin {k['plain_ms']:.4f} ms; "
              f"{_fmt_device(busy, k['device'])}; "
              f"{k['bytes'] / 1e6:.2f} MB of operands -> "
              f"{k['bytes'] / k['ms'] / 1e6:.0f} GB/s by event time "
              f"({card})", flush=True)
    # the stream read once for 8 right-hand sides against 8 reads: the
    # MM(8) kernel's device time beside 8x its SpMV form's, same plan
    for mm, mv, kernel in (("bell2_spmm", "bell2_spmv", "bell2_spmv_kernel"),
                           ("sbell_spmm", "sbell_spmv", "sbell_spmv_kernel"),
                           ("sdia_sym_mm", "sdia_sym", "sdia_sym_kernel")):
        t_mm = kern[mm]["device"].get(kernel, 0.0)
        t_mv = kern[mv]["device"].get(kernel, 0.0)
        print(f"MM({RHS}) vs {RHS}x SpMV device time, {kernel} on "
              f"{kern[mv]['on']}: MM({RHS}) {t_mm:.4f} ms, SpMV {t_mv:.4f} "
              f"ms (0: not measured), ratio MM / ({RHS} SpMV) "
              f"{_ratio(t_mm, RHS * t_mv)} ({card})", flush=True)
    for name in RUNS:
        A, d, xe = operands(name)
        general = isinstance(d, ops.Bell2Device)
        apply = ops.bell2_apply if general else ops.sbell_apply
        apply_mm = ops.bell2_apply_mm if general else ops.sbell_apply_mm
        yk = apply(d, xe)
        yp = apply(d, xe, plain=True)
        e2e_err = float((yk - yp).abs().max())
        ms_k = _median_ms(torch, lambda: apply(d, xe))
        ms_p = _median_ms(torch, lambda: apply(d, xe, plain=True))
        busy, by_name = _device_ms(torch, lambda: apply(d, xe))
        nnz = A.tuned.nnz_full
        print(
            f"end to end {name}: kernel path {ms_k:.4f} ms "
            f"({nnz / ms_k / 1e6:.2f} Gnnz/s), plain path {ms_p:.4f} ms "
            f"({nnz / ms_p / 1e6:.2f} Gnnz/s), max |kernel - plain| "
            f"{e2e_err}; kernel path {_fmt_device(busy, by_name)}; "
            f"n={A.nrows} nnz_full={nnz} ({card})",
            flush=True,
        )
        # SpMM(8): the MM kernel path, its plain path, and 8 SpMV applies
        Xe = torch.rand((A.ncols, RHS), generator=g).to(dev)
        cols = [Xe[:, b].contiguous() for b in range(RHS)]
        Yk = apply_mm(d, Xe)
        Yp = apply_mm(d, Xe, plain=True)
        mm_err = float((Yk - Yp).abs().max())
        ms_mm = _median_ms(torch, lambda: apply_mm(d, Xe))
        ms_mm_p = _median_ms(torch, lambda: apply_mm(d, Xe, plain=True))
        ms_8 = _median_ms(torch, lambda: [apply(d, c) for c in cols])
        busy_mm, by_mm = _device_ms(torch, lambda: apply_mm(d, Xe))
        busy_8, _ = _device_ms(torch, lambda: [apply(d, c) for c in cols])
        print(
            f"end to end {name} SpMM({RHS}): kernel path {ms_mm:.4f} ms "
            f"({RHS * nnz / ms_mm / 1e6:.2f} Gnnz/s), plain path "
            f"{ms_mm_p:.4f} ms, {RHS} SpMV applies {ms_8:.4f} ms; max "
            f"|kernel - plain| {mm_err}; kernel path "
            f"{_fmt_device(busy_mm, by_mm)}; {RHS} SpMV applies device "
            f"{busy_8:.4f} ms, ratio {_ratio(busy_mm, busy_8)} ({card})",
            flush=True,
        )
    phase_done("5 times")

    # -- 6. the differential CLI on a written .mtx ----------------------
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "near_band_paired_20k.mtx")
    coo = near_band_paired(n=20_000, seed=2).to_coo()
    write_mmf(path, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = test_cli([path, "1", "--device", "cuda"])
    said = buf.getvalue().strip()
    print(f"cli test_spmv_mmf {path} 1 --device cuda: {said!r} exit {rc}",
          flush=True)
    if rc != 0 or not said.endswith("PASSED!"):
        raise AssertionError("the differential CLI did not pass")
    phase_done("6 cli")
    print(f"total wall time {time.perf_counter() - t_start:.2f} s",
          flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "cfs_spmv_tpu_torch/csrc/spmv_kernels.cu",
            "replaces": REPLACES[name],
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
