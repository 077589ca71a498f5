#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cfs_spmv_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each prints its wall time):

1. card name and power limit (``nvidia-smi``), PyTorch and CUDA versions;
2. build the CUDA kernels from ``cfs_spmv_tpu_torch/csrc/spmv_kernels.cu``,
   and beside that build ptxas' report;
2b. ptxas' report (``nvcc -Xptxas -v``) of registers and spills for every
   kernel instance; any spill fails the run;
3. the main paths, once each, through the user entry points —
   ``SparseMatrix.create(csr, fmt)`` then
   ``SpDMV(A, tuning, dtype=np.float32)(x)`` and
   ``SpDMM(A, tuning, dtype=np.float32)(X)`` with X of B = 8 columns
   (SpMM, ROADMAP A7), on the default device, which is the card — on
   twelve full-size runs (``RUNS``): the tuned symmetric path on
   ``cant_proxy()``, ``audikw_proxy()``, the 65,536-row flagship and
   ``stencil27()`` (64,000 rows, offsets past a value block); the
   general path on ``general_asym()`` and on the flagship as a general
   matrix; the untuned oracle path (``Tuning.NONE``) on
   ``cant_proxy()``; the paired stream on ``near_band_paired()`` with
   ``CFS_PAIRED=force``, and the same matrix under the default
   ``CFS_PAIRED=auto`` gate (which routes it to the one-sided stream);
   mirrored diagonals on ``cant_proxy()`` with ``SDIA_SYM_ROWS_MAX``
   below its size; ``near_band_paired(n=400_000)``, the same structure at
   8x (a paired stream past the 50 MB L2, in several output blocks), with
   ``CFS_PAIRED=force`` and under the default gate. Each result (each column of Y) is checked against
   the float64 host oracle. The kernels' launch counts are zeroed just
   before each apply and read just after; each SpMV apply must launch
   exactly the kernels its plan predicts (and ``EXPECTED`` lists), each
   SpMM apply exactly their multi-RHS forms (``EXPECTED_MM``) and no
   SpMV kernel. Then the float64 route (ROADMAP A8) the same way, with
   ``dtype=np.float64``, on five full-size runs (``cant_proxy()`` and
   ``stencil27()``: the symmetric diagonal stream with the halved main
   diagonal only;
   ``audikw_proxy()``: the expanded one-sided stream; the flagship:
   both, the peel residual as a double entry list; ``general_asym()``:
   one-sided), each checked against the float64
   oracle at the float64 gate (1e-8) with its scaled error printed beside
   the float32 run's, and an fp64 apply may move no fp32 kernel's count;
   and one apply of the plain ELL+COO path (``CFS_FP64=xla``) on the
   flagship, which may move no kernel's count at all; for each
   accumulating stream (the sparse residuals of the flagship, the
   flagship as a general matrix and forced pairing, and the float64
   flagship's peel residual) the chunk grid's padded bytes beside the
   bytes of the entry list that is uploaded in its place, and the fill;
   then the bfloat16 values (``values="bfloat16"``, ROADMAP A5) the same
   way on seven runs (``BF16_RUNS``: ``cant_proxy()``, ``audikw_proxy()``
   without reordering, the flagship, ``stencil27()``, ``general_asym()``,
   the flagship as CSR and ``near_band_paired()`` with
   ``CFS_PAIRED=force``), each apply held to the oracle at a 2-byte
   type's gate (5e-2) with its largest scaled difference from the
   float32 apply of the same matrix and x printed, and required to launch
   exactly the bf16 instances its plan predicts and no float32 one (the
   unpermute reads no values and runs as it is);
4. each kernel against its plain PyTorch twin on the same card, on the
   real plan arrays of those runs (``sbell_spmv`` also replanned with the
   other transpose-window count and with 8-tile output blocks, and on the
   400,000-row plan; on each plan also with a zero x into NaN-poisoned
   planes at a plane stride past the plane, which must come back all zero
   where the plan covers them and untouched past them; a paired plan that
   leaves an output block unvisited must be refused at upload;
   ``sdia_gen`` on a ragged ``general_asym(g=50)`` plan, ``general_asym()``,
   the flagship as CSR and mirrored ``cant_proxy()``, adding from padded x
   and storing from x itself into NaN-poisoned tiles; ``sdia_sym``
   on ``stencil27()`` and ``cant_proxy()``, onto a nonzero y, and over
   planes with x staged as the plan says and both ways); each
   multi-RHS kernel at B = 8 and at B = 11 (two plane groups), into
   NaN-poisoned outputs where the kernel zeroes its own (``bell2_spmm`` on
   an 8-tile-block replan with an absent row range, whose unvisited
   blocks must keep their NaN, on ``cant_proxy()``'s untuned stream and
   on ``audikw_proxy()``'s far stream, the two that visit every block
   zeroed whole), ``sdia_sym_mm`` onto nonzero Y planes at a plane stride
   past the plane, which nothing may write past, ``sbell_spmm``
   also with the other transpose-window count and on the 8-tile-block
   replan (both also at B = 2, the two-plane instance) and on the
   400,000-row plan, from x planes at a plane stride past the plane,
   ``sdia_gen_mm`` on the four plans of ``sdia_gen`` at B = 1, 2, 4, 8
   and 11 from X in place and from its interleaved copy, adding onto
   nonzero and storing into NaN-poisoned strided planes (the store form's
   rows past the value blocks must read +0); the unpermute's gather, seed
   and into forms, SpMV and at B = 1, 2, 4, 8, 11, on ``audikw_proxy()``'s
   far stream and on a degree-grouped replan over 8-tile blocks with an
   absent row range, out of NaN-poisoned allocations, bit-identical to the
   composed twins; the float64 kernels at B = 1, 8 and 11 (scaled error
   against the float64 twin below ``F64_TWIN_TOL``), the diagonal ones on
   ``stencil27()`` and ``cant_proxy()`` onto strided Y planes, the grid
   ones on ``general_asym()`` and ``audikw_proxy()`` in float64 and on an
   8-tile-block replan with an absent row range into NaN-poisoned
   outputs; the double entry kernel (``bell2_spmv_accum_df``,
   ``bell2_spmm_accum_df``) on the float64 flagship's peel residual and on
   that replan's entry list (the upload takes it as entries), onto strided
   NaN-poisoned planes seeded finite on the named rows, against the
   chunk-grid twin; the one-sided float SpMV kernel (B2) in float32 and
   bf16 on ``audikw_proxy()``'s far stream, ``cant_proxy()`` NONE, shard 1
   of D3's far grids (``general_asym()`` over 4 shards, the operator phase
   8 applies) and the float replan with absent rows, into NaN-poisoned
   tiles after either zero pass, and whether it repeats bit for bit; the
   accumulating kernels (``bell2_spmv_accum``, ``bell2_spmm_accum``) on
   the flagship's entry list and on a hand-built one with an absent row
   range and rows of 70 and 200 entries, at B = 1, 8 and 11 onto Y planes
   at a plane stride past the plane whose rows no entry names hold NaN and
   must keep it bit for bit, and against the chunk-grid twin on the same
   plan's padded arrays; then each bf16 instance against its twin (which
   computes on the values widened to float32) on the bf16 runs' plan
   arrays and on the replans over 8-tile blocks with absent rows cast to
   bf16, at B = 11 and 8 over planes, into NaN-poisoned or strided outputs
   as above; then the double instances of the paired and signed diagonal
   kernels (``<name>_f64``, the float64 ``DistSpDMV``'s) on shard 1 of
   phase 8's float64 D5 (paired) and D1 (mirrored) operators and on
   replans of both matrices without rows 20,000-29,999 (the paired one
   over 8-tile blocks), each against its float64 twin: B5 into
   NaN-poisoned tiles; B10 (one launch and one zero pass a group of up to
   8 planes, checked in device launches at B = 8) at B = 1, 2, 4, 8 and
   11 into NaN-poisoned strided planes and a zero x into NaN-poisoned
   strided planes, with its walk and shared memory a CTA; B6 adding and
   storing; B12 (x staged in shared memory over the plan's window) at
   B = 1, 2, 4, 8, 11 from X in place and copied, adding and storing, and
   a zero X storing +0, with the shared memory a CTA; and the library
   calls of the double instances (the float64 sparse CSR product of the
   same stream, ``paired_csr`` and ``dia_csr``) held to the twin;
5. times per call (CUDA events around 20 back-to-back calls, median of
   5) of each kernel and twin (multi-RHS ones at B = 8), and of the
   kernel path and the plain path of every run, SpMV and SpMM(8) (the
   paired kernels also on the 400,000-row plan; the float64 grid
   kernels also on ``general_asym()``, so that B15 and B16 each have a
   time on the float64 flagship's residual as entries, on
   ``general_asym()`` and on ``audikw_proxy()``), with
   the device time of each apply and of each kernel from
   ``torch.profiler``; for ``bell2_spmm``, ``sbell_spmm`` and
   ``sdia_sym_mm`` the MM(8) kernel's device time beside 8x its SpMV
   form's on the same plan, and for every run the SpMM(8) apply beside
   8 SpMV applies; beside each kernel its bound (the least time the card
   could take: the larger of its bytes over ``HBM_BYTES_PER_S`` and its
   operations over the card's peak rate for the type) and the time of the
   one PyTorch call that computes the same function (a sparse CSR product
   of the same stream or matrix, ``index_select`` for the unpermute),
   and for every matrix ``torch.sparse_csr_tensor(A) @ x`` and ``@ X`` in
   float32 and float64, and the rows PERF.md §6 holds for other plans
   (``stencil27()``'s diagonal kernels, B7 on ``cant_proxy()`` NONE, B6
   and B12 on the flagship as CSR and mirrored cant); for every run the
   device launches of each apply; and for every run the SpMV apply as ``utils/timing.time_matvec`` times it
   (``GRAPH_ITERS`` applies captured into one CUDA graph, replayed
   between CUDA events) beside the eager apply's wall and device time,
   with both idle shares; each bf16 run's SpMV apply (eager, graphed and
   device time) and SpMM(8) device time beside the float32 apply of the
   same matrix, with both plans' ``stream_bytes()`` (a bf16 kernel row's
   library call is the CSR product with the values rounded to bf16 and
   stored in float32); and the plan cache on the card: ``cant_proxy()``
   tuned in bf16 twice into one directory, the second a load whose apply
   is bit-identical to the first's.
   These library calls are timed here and used nowhere in the port;
5b. the float64 SpMM of a diagonal-only plan at the benchmark's hpcg-256
   shape (16,777,216 rows, HPCG's 14 lower diagonals, random planes, a
   random row-major X of 8 columns): ``sdia_sym_rows_df_mm`` against its
   twin and against B14 over planes, then its device ms beside the planes
   composition it replaced (``pad_x_mm``, the zeroed output, B14), in
   turns;
6. the differential CLI (``cfs_spmv_tpu_torch.cli.test_spmv_mmf``) on a
   written ``.mtx`` on its default device; it must print ``PASSED!``;
   and an untuned ``A @ x`` with a numpy x, ``A.tune()`` and ``tune(csr)``
   with no device named, which must all land on the card;
7. the solvers (``models/solvers.py``) at full width, each through its
   public entry point (its loop replayed as a CUDA graph under
   ``set_sync_debug_mode("error")``), then eagerly with the kernels and
   eagerly through the appliers' plain twins: S1 ``cg`` in float32 on
   the 2-D Laplacian of ``examples/cg_poisson_torch.py`` at
   g = ``SOLVER_GRID`` (4,194,304 rows), 1,000 iterations, plain and
   with ``diag_precond``; S2 the same in float64; S3 ``bicgstab`` on
   ``general_asym()``, 200 iterations, float32 and float64; S4
   ``gmres(restart=32, outer=4)`` there in float32; S5 ``jacobi``
   (omega 0.8) and ``chebyshev`` (the Laplacian's analytic spectral
   bounds) on the same Laplacian, 200 iterations each; S6
   ``lanczos(iters=64)`` and ``power_iteration(iters=200)`` on
   ``cant_proxy()``. Each solve launches only its path's kernels (counts
   zeroed before its graphed run and read after), replays its graph once
   an iteration, agrees with its eager runs (``SOLVE_TOL``; printed: bit
   for bit with the eager kernel run or not) and shows its residual's
   fall (``SOLVES``); per iteration it prints the graphed and eager wall
   (CUDA events around the loop), the device busy time (profiler) and
   both idle shares. Then S1 with bfloat16 values, graphed, beside the
   float32 S1 (bit for bit expected: the Laplacian's values are exact in
   bf16; the first difference is printed), and
   ``examples/cg_poisson_torch.py`` at its default (g = 256) must pass;
8. the distributed layer (``parallel/dist.DistSpDMV``) on P shards of card
   0 (``make_mesh(P, device="cuda:0")``, every exchange a copy within the
   card), the
   cases of ``DIST_CASES``: ``cant_proxy()`` at P = 1, 2 and 4 (auto:
   gather at P = 1, halo past it) and at P = 4 with
   ``CFS_DIST_SDIA_ROWS_MAX`` below its shard (mirrored diagonals);
   ``audikw_proxy()`` at P = 4 with auto (halo), gather and ring;
   ``general_asym()`` at P = 4; ``stencil27()`` at P = 4 with ring; and
   ``near_band_paired()`` at P = 4 with ``CFS_PAIRED=force`` (the default
   gate pairs no shard of the others); in float64 (``dtype=np.float64``)
   ``cant_proxy()`` at P = 4, plain and mirrored, ``near_band_paired()``
   forced and ``general_asym()``, at P = 4; SpMM(8) on nine of them. Each
   apply launches exactly what its shards' device structs predict
   (``predict_dist``: an empty ring stream launches nothing; an SpMM
   apply no SpMV kernel), agrees with the float64 oracle, with its plain
   twins' path and with the single-device apply of the same matrix and
   type (at the type's gate), and prints its comm, halo rows, graphed,
   eager and device time beside the single-device apply's; then S1 ``cg``
   (100 iterations) graphed over the 4-shard ``cant_proxy()`` operator
   against its eager run;
9. one NCCL rank (``NCCL_CASES``), in a child process (``chip_smoke.py
   --nccl-rank``; the card's machine has one card, and NCCL takes one rank
   a card): ``parallel/multihost.initialize`` over ``tcp://localhost``,
   ``DistSpDMV`` over the process-group mesh of ``make_mesh()`` (its
   shard's buffers filled from the global x on its card, y all-gathered) in float32 and float64,
   SpMV and SpMM(8), launches against the prediction, held to the
   single-process operator on card 0 and to the oracle, timed graphed
   (the all-gather captured in the CUDA graph) and by device time beside
   it.

It needs one card and imports nothing of JAX. Any failure raises, and the
exit code is then nonzero; without CUDA it exits 1 at once. The last two
lines of standard output are one JSON object per line: the kernels (their
``launches`` summed over the main paths of phase 3, the graphed solves of
phase 7, the distributed applies and solve of phase 8 and phase 9's
rank; the bf16 instances as ``<name>_bf16``, the double instances of the
paired and signed diagonal kernels as ``<name>_f64``), then ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import shutil
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
    # 13 lower diagonals, the largest offsets (1,559-1,641) past a value
    # block of 1,024 rows
    "stencil27": {"sdia_sym"},
    # the paired stream past the L2 (400,000 rows, several output blocks),
    # and the default gate's choice there: one accumulating entry list
    "near_band_paired_400k": {"sbell_spmv", "bell2_spmv_accum"},
    # (the entry list alone: its rows and D x in one pass)
    "near_band_paired_400k_auto": {"bell2_entries_rows"},
    # the float64 route
    "cant_proxy_f64": {"sdia_sym_df"},  # diagonals incl. the halved main
    "audikw_proxy_f64": {"bell2_spmv_df"},  # peel rejected: all one-sided
    # peel + its residual as a double entry list
    "flagship_f64": {"sdia_sym_df", "bell2_spmv_accum_df"},
    "general_asym_f64": {"bell2_spmv_df"},  # asymmetric: all one-sided
    # 14 diagonals incl. the halved main one, nothing left for the stream
    "stencil27_f64": {"sdia_sym_df"},
    # bfloat16 values (``values="bfloat16"``): the bf16 instances of the
    # same plans' kernels; the unpermute reads no values and runs as it is
    "cant_proxy_bf16": {"sdia_sym_bf16"},
    "audikw_proxy_bf16": {"bell2_spmv_bf16", "unperm_gather"},
    "flagship_bf16": {"sdia_sym_bf16", "bell2_spmv_accum_bf16"},
    "stencil27_bf16": {"sdia_sym_bf16"},
    "general_asym_bf16": {"sdia_gen_bf16"},
    "flagship_csr_bf16": {"sdia_gen_bf16", "bell2_spmv_accum_bf16"},
    "near_band_paired_bf16": {"sbell_spmv_bf16", "bell2_spmv_accum_bf16"},
}
#: the kernels that read the stream's values: each has a bf16 instance,
#: whose launches its wrapper counts apart (``launches_bf16``) and which
#: the ``kernels`` line lists as ``<name>_bf16``
BF16_KERNELS = ("sdia_sym", "bell2_spmv", "bell2_spmv_accum", "sbell_spmv",
                "sdia_gen", "sdia_sym_mm", "bell2_spmm", "bell2_spmm_accum",
                "sbell_spmm", "sdia_gen_mm")
#: the bf16 main paths: name -> (the float32 run of the same plan, or None
#: where phase 3 has none, and reorder); the matrix, format and planning
#: are those of the run the name less "_bf16" names in ``RUNS``
BF16_RUNS = {
    "cant_proxy_bf16": ("cant_proxy", "auto"),
    # the reference bench's audikw_scattered_bf16: no reordering
    "audikw_proxy_bf16": (None, False),
    "flagship_bf16": ("flagship", "auto"),
    "stencil27_bf16": ("stencil27", "auto"),
    "general_asym_bf16": ("general_asym", "auto"),
    "flagship_csr_bf16": ("flagship_csr", "auto"),
    "near_band_paired_bf16": ("near_band_paired", "auto"),
}
#: the kernels whose wrappers also take float64 values with float64 x and
#: y (the float64 DistSpDMV's paired shards and mirrored diagonals, phase
#: 8): each counts its double instance apart (``launches_f64``), which the
#: ``kernels`` line lists as ``<name>_f64``
F64_KERNELS = ("sbell_spmv", "sbell_spmm", "sdia_gen", "sdia_gen_mm")
#: the kernel a float64 distributed apply runs in place of each float32
#: one (``ops/spmv._F64_ROLES``; the paired and signed diagonal wrappers
#: run their double instances)
F64_OF = {"sdia_sym": "sdia_sym_df", "bell2_spmv": "bell2_spmv_df",
          "bell2_spmv_accum": "bell2_spmv_accum_df",
          "sbell_spmv": "sbell_spmv_f64", "sdia_gen": "sdia_gen_f64"}
#: the multi-RHS form of each kernel: an SpMM apply runs the same
#: branches as the SpMV apply of its plan, through these
MM_OF = {
    "sdia_sym": "sdia_sym_mm",
    "bell2_spmv": "bell2_spmm",
    "bell2_spmv_accum": "bell2_spmm_accum",
    # the SpMM apply of an entry list alone keeps B8
    "bell2_entries_rows": "bell2_spmm_accum",
    "unperm_gather": "unperm_gather_mm",
    "sbell_spmv": "sbell_spmm",
    "sdia_gen": "sdia_gen_mm",
    "sdia_sym_df": "sdia_sym_df_mm",
    "bell2_spmv_df": "bell2_spmm_df",
    "bell2_spmv_accum_df": "bell2_spmm_accum_df",
    **{f"{k}_bf16": f"{mm}_bf16" for k, mm in (
        ("sdia_sym", "sdia_sym_mm"), ("bell2_spmv", "bell2_spmm"),
        ("bell2_spmv_accum", "bell2_spmm_accum"),
        ("sbell_spmv", "sbell_spmm"), ("sdia_gen", "sdia_gen_mm"))},
    "sbell_spmv_f64": "sbell_spmm_f64",
    "sdia_gen_f64": "sdia_gen_mm_f64",
}
#: kernels each main-path run's SpMM(8) apply launches (no SpMV kernel)
EXPECTED_MM = {run: {MM_OF[k] for k in ks} for run, ks in EXPECTED.items()}
# a float64 plan of diagonals only multiplies a row-major X where it lies
# (``ops/spmv._rows_path``): the row-major kernel, no planes
EXPECTED_MM.update({run: {"sdia_sym_rows_df_mm"}
                    for run in ("cant_proxy_f64", "stencil27_f64")})
#: the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "sdia_sym": "cfs_spmv_tpu/ops/sdia_kernel.py:157",
    "bell2_spmv": "cfs_spmv_tpu/ops/bell2_kernel.py:812",
    "bell2_spmv_accum": "cfs_spmv_tpu/ops/bell2_kernel.py:939",
    "bell2_entries_rows": "cfs_spmv_tpu/ops/bell2_kernel.py:939",
    "unperm_gather": "cfs_spmv_tpu/ops/bell2_kernel.py:1216",
    "sbell_spmv": "cfs_spmv_tpu/ops/bell2_kernel.py:1385",
    "sdia_gen": "cfs_spmv_tpu/ops/sdia_kernel.py:251",
    "bell2_spmm": "cfs_spmv_tpu/ops/bell2_kernel.py:1084",
    "bell2_spmm_accum": "cfs_spmv_tpu/ops/bell2_kernel.py:1562",
    "unperm_gather_mm": "cfs_spmv_tpu/ops/bell2_kernel.py:1264",
    "sbell_spmm": "cfs_spmv_tpu/ops/bell2_kernel.py:1468",
    "sdia_sym_mm": "cfs_spmv_tpu/ops/sdia_kernel.py:391",
    "sdia_gen_mm": "cfs_spmv_tpu/ops/sdia_kernel.py:326",
    "sdia_sym_df": "cfs_spmv_tpu/ops/sdia_df.py:167",
    "sdia_sym_df_mm": "cfs_spmv_tpu/ops/sdia_df.py:222",
    # the same TPU kernel over a row-major X and Y (a diagonal-only plan)
    "sdia_sym_rows_df_mm": "cfs_spmv_tpu/ops/sdia_df.py:222",
    "bell2_spmv_df": "cfs_spmv_tpu/ops/bell2_df.py:181",
    "bell2_spmm_df": "cfs_spmv_tpu/ops/bell2_df.py:322",
    # the same two TPU kernels on a float64 peel residual, as entries
    "bell2_spmv_accum_df": "cfs_spmv_tpu/ops/bell2_df.py:181",
    "bell2_spmm_accum_df": "cfs_spmv_tpu/ops/bell2_df.py:322",
}
REPLACES.update({f"{k}_bf16": REPLACES[k] for k in BF16_KERNELS})
REPLACES.update({f"{k}_f64": REPLACES[k] for k in F64_KERNELS})


class _Count:
    """The count of one instance type of a wrapper (its ``launches_bf16``
    or ``launches_f64``), read and set as ``launches``, as the phases read
    and zero every wrapper's count."""

    def __init__(self, wrapper, tag):
        self.wrapper, self.attr = wrapper, f"launches_{tag}"
        self.__name__ = f"{wrapper.__name__} ({tag})"

    @property
    def launches(self):
        return getattr(self.wrapper, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.wrapper, self.attr, n)
#: the card's peaks for the bounds (NVIDIA H100 SXM data sheet): device
#: memory bytes per second, and multiply-adds counted as two operations
#: per second outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: scaled error |kernel - twin| / (|A| |x|) allowed between a float64
#: kernel and its float64 twin: both round each product once and differ
#: in summation order only (a few 1e-16 per term)
F64_TWIN_TOL = 1e-12
TIMED_CALLS = 20
#: applies ``utils/timing.time_matvec`` captures into one CUDA graph
GRAPH_ITERS = 200
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
    wrappers' host overhead is not in it. (None, {}) where the profiler
    saw no device events in three tries: that time was not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(3):  # a window now and then comes back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                # "void (anonymous namespace)::sbell_spmv_kernel<4>(...)"
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("<")[0].split("::")[-1]
                name = name.replace("void ", "").strip()[:40]
                by_name[name] = (by_name.get(name, 0.0)
                                 + e.device_time_total / 1e3 / calls)
        if by_name:
            break
    return (sum(by_name.values()) if by_name else None), by_name


def _device_launches(torch, fn, calls=5):
    """Device launches (kernels, memsets, copies) per call of ``fn``, as
    ``torch.profiler`` counts the card's events over ``calls`` calls, the
    most of three windows, rounded (a window now and then misses the
    event at its start: 14 events for 5 calls of 3); "not measured" where
    it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0  # a window may lose events, never gain them
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.device_type == DeviceType.CUDA
                             for e in prof.events()))
    return str(round(most / calls)) if most else "not measured"


def _fmt_device(busy, by_name):
    if not by_name:
        return "device time not measured (the profiler saw no device events)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return f"device {busy:.4f} ms (" + ", ".join(
        f"{k} {v:.4f}" for k, v in top) + ")"


def _ms(t):
    """A device time for a text line; None reads "not measured"."""
    return "not measured" if t is None else f"{t:.4f}"


def _ratio(num, den):
    """num / den, or "not measured" where the profiler saw no device
    events for either."""
    return f"{num / den:.3f}" if num and den else "not measured"


def _nbytes(*tensors):
    """Bytes the tensors occupy: what a kernel must at least move."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops, dtype):
    """(bound ms, "bytes" | "operations"): the least time the card could
    take for ``nbytes`` moved (each input read once, each output written
    once) and ``flops`` operations of ``dtype`` (two per multiply-add on
    a stored nonzero of this run's data)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: the nvcc processes started; one still running at exit is killed
_STARTED = []


def _smoke_dir():
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def _nvcc_start(out, src, *more):
    """Start nvcc with the port's flags on ``src`` (ptxas' report builds
    beside the port's own build)."""
    from cfs_spmv_tpu_torch.ops import _cuda

    with open(out + ".log", "w") as log:  # ptxas' report outgrows a pipe
        proc = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *more, "-o", out, src],
            stdout=log, stderr=subprocess.STDOUT)
    proc.log = out + ".log"
    _STARTED.append(proc)
    return proc


def _nvcc_wait(proc, what):
    """What nvcc said, once it has ended; raises when it failed."""
    proc.wait()
    with open(proc.log) as f:
        said = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{said}")
    return said


def ptxas_start():
    """Compile the kernel source once more with ``-Xptxas -v`` (same flags
    otherwise, output discarded)."""
    from cfs_spmv_tpu_torch.ops import _cuda

    return _nvcc_start(os.path.join(_smoke_dir(), "ptxas_probe.so"),
                       _cuda._SRC, "-Xptxas", "-v")


def ptxas_report(text):
    """{kernel instance: (registers, spill bytes)} from the text of
    ``nvcc -Xptxas -v``."""
    import re

    from cfs_spmv_tpu_torch.ops import _cuda

    filt = os.path.join(os.path.dirname(_cuda._nvcc()), "cu++filt")
    if os.path.exists(filt):
        text = subprocess.run([filt], input=text, capture_output=True,
                              text=True).stdout or text
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(.*)' for", line)
        if m:
            # "void <unnamed>::k<(bool)1, (int)8, double>(const T1 *, ...)"
            k = re.search(r"(\w+_kernel(?:<.*?>)?)\(", m.group(1))
            name = (k.group(1) if k else m.group(1)).replace("(bool)", "")
            name = name.replace("(int)", "")
            report[name] = [None, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            report[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name][0] = int(m.group(1))
    if not report:
        raise RuntimeError(f"no ptxas report in nvcc's output:\n{text}")
    return {k: tuple(v) for k, v in report.items()}


def _regs_line(regs):
    return "; ".join(
        f"{k} {v[0]}" + (f" (+{v[1]} B spilled)" if v[1] else "")
        for k, v in sorted(regs.items()))


def stream_csr(torch, d):
    """The one-sided BELL2 stream of ``d`` (a device struct, or
    :func:`grid_on` of a host plan) as a
    ``torch.sparse_csr_tensor`` of shape (padded tiles * 128, x rows *
    128), for the library yardstick: its product with the flat padded x
    is what ``bell2_spmv`` computes into its tiles. Decoded as the plain
    twin decodes it; built once, outside any timing."""
    C = d.meta.shape[0]
    K, BT = d.chunks_per_step, d.tiles_per_block
    pk = d.packed.reshape(C, 8, 128).long()
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 0x1F, 2, q)
    meta = d.meta.long()
    if d.contig:
        xrow = meta[:, 2, None, None] + r2
    else:
        cidx = torch.arange(C, device=meta.device)[:, None, None]
        xrow = meta[:, 2:].reshape(-1)[cidx * 8 + (r2 & 7)]
    tgt = d.step_block.long().repeat_interleave(K) * BT + meta[:, 0]
    lane = torch.arange(128, device=meta.device)
    rows = (tgt[:, None, None] * 128 + lane).expand(C, 8, 128)
    vals = d.vals.reshape(C, 8, 128)
    live = vals != 0
    TP = -(-d.num_row_tiles // BT) * BT
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[live], (xrow * 128 + q)[live]]), vals[live],
        (TP * 128, d.x_rows * 128)).coalesce()
    return coo.to_sparse_csr()


def paired_csr(torch, dp):
    """The paired stream of ``dp`` (an ``SBellDevice``) as a
    ``torch.sparse_csr_tensor`` of shape (padded tiles * 128, x rows *
    128), for the library yardstick: each stored strict-lower value at
    (r, c), decoded from its row side as the plain twin decodes it, and
    its mirror at (c, r), so its product with the flat padded x is what
    ``sbell_spmv`` computes into its tiles. Built once, outside any
    timing."""
    C = dp.meta.shape[0]
    K, BT, TW = dp.chunks_per_step, dp.tiles_per_block, dp.transpose_windows
    pk = dp.packed.reshape(C, 8, 128).long()
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 7, 2, q)
    meta = dp.meta.long()
    cidx = torch.arange(C, device=meta.device)[:, None, None]
    win = meta[:, 2:2 + TW].reshape(-1)[cidx * TW + r2.clamp(max=TW - 1)]
    tgt = dp.step_block.long().repeat_interleave(K) * BT + meta[:, 0]
    lane = torch.arange(128, device=meta.device)
    rows = (tgt[:, None, None] * 128 + lane).expand(C, 8, 128)
    cols = win * 128 + q
    vals = dp.vals.reshape(C, 8, 128)
    live = (vals != 0) & (r2 < TW)
    r, c, v = rows[live], cols[live], vals[live]
    TP = -(-dp.num_row_tiles // BT) * BT
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat([r, c]), torch.cat([c, r])]),
        torch.cat([v, v]), (TP * 128, dp.x_rows * 128)).coalesce()
    return coo.to_sparse_csr()


def dia_csr(torch, vals, offsets, nrows, ncols):
    """The signed diagonals ``vals`` (R, D, 8, 128) at ``offsets`` as a
    ``torch.sparse_csr_tensor`` of shape (nrows, ncols), for the library
    yardstick: row g holds diagonal j's value at column g - offsets[j]
    where that column lies in x, which is what ``sdia_gen`` adds into its
    rows. Built once, outside any timing."""
    D = vals.shape[1]
    N = min(vals.shape[0] * 1024, nrows)
    vd = vals.permute(1, 0, 2, 3).reshape(D, -1)[:, :N]
    rows = torch.arange(N, device=vals.device).expand(D, N)
    cols = rows - offsets.long()[:, None]
    live = (vd != 0) & (cols >= 0) & (cols < ncols)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[live], cols[live]]), vd[live],
        (nrows, ncols)).coalesce()
    return coo.to_sparse_csr()


def grid_on(torch, plan, device):
    """The chunk grid of a host ``Bell2Plan`` on ``device``, with the
    geometry fields :func:`stream_csr` and the chunk-grid twins read (an
    accumulating stream's device struct holds its entries only)."""
    import types

    return types.SimpleNamespace(
        **{k: torch.as_tensor(np.ascontiguousarray(getattr(plan, k))).to(
            device) for k in ("vals", "packed", "meta", "step_block")},
        chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block,
        num_row_tiles=plan.num_row_tiles, x_rows=plan.x_rows,
        contig=plan.windows_contig or plan.window_depth > 8)


def matrix_csr(torch, csr, dtype, device):
    """The full (expanded) matrix as a ``torch.sparse_csr_tensor``."""
    from cfs_spmv_tpu_torch import CSR

    full = (CSR.from_coo(csr.to_coo().expand_symmetric())
            if csr.symmetric else csr)
    return torch.sparse_csr_tensor(
        torch.as_tensor(np.asarray(full.indptr, np.int64)),
        torch.as_tensor(np.asarray(full.indices, np.int64)),
        torch.as_tensor(np.asarray(full.data)).to(dtype),
        size=(full.nrows, full.ncols)).to(device)


def _agree(y, y_ref, scale, nnz_per_row, what):
    """allclose_spmv on card results (any shape: an MM result is checked
    element by element, each plane being one SpMV's); returns max
    |y - y_ref|. float64 results are held to ``F64_TWIN_TOL`` on the
    scaled error instead."""
    import torch

    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

    f64 = y.dtype == torch.float64
    y, y_ref = y.double().cpu().numpy(), y_ref.double().cpu().numpy()
    scale = scale.double().cpu().numpy()
    if not (np.isfinite(y).all() and y.shape == y_ref.shape):
        raise AssertionError(f"{what}: non-finite or misshapen result")
    if f64:
        worst = float((np.abs(y - y_ref) / np.maximum(scale, 1e-300)).max())
        if not worst < F64_TWIN_TOL:
            raise AssertionError(
                f"{what}: scaled error {worst} against the float64 twin "
                f"(bar {F64_TWIN_TOL})")
    elif not allclose_spmv(y, y_ref, np.float32, nnz_per_row=nnz_per_row,
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
    struct (the branches of ``ops/spmv.bell2_apply`` / ``sbell_apply`` /
    ``fp64_apply``)."""
    from cfs_spmv_tpu_torch.ops.spmv import Bell2Device, Fp64Device

    dev = tuned.operands
    dev = dev["dev"] if isinstance(dev, dict) else dev
    out = set()
    if isinstance(dev, Fp64Device):
        if dev.entries is not None:
            out.add("bell2_spmv_accum_df")
        elif dev.has_work:
            out.add("bell2_spmv_df")
        if dev.dia_vals is not None:
            out.add("sdia_sym_df")
        return out
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
                else {"bell2_entries_rows"} if dev.far_rows is not None
                and not dev.has_paired and dev.dia_vals is None
                else {"bell2_spmv_accum"})
    if dev.dia_vals is not None:
        out.add("sdia_gen" if dev.dia_mirrored else "sdia_sym")
    return out


def predict_mm(tuned) -> set:
    """The kernels an SpMM apply of ``tuned`` over a contiguous (n, 8) X
    launches: the multi-RHS forms of :func:`predict`'s, or for a float64
    plan of diagonals only the row-major kernel (``ops/spmv._rows_path``)."""
    from cfs_spmv_tpu_torch.ops.spmv import Fp64Device

    dev = tuned.operands
    dev = dev["dev"] if isinstance(dev, dict) else dev
    if (isinstance(dev, Fp64Device) and dev.entries is None
            and not dev.has_work and dev.dia_vals is not None):
        return {"sdia_sym_rows_df_mm"}
    return {MM_OF[k] for k in predict(tuned)}


#: iterations a solve of the solver phase runs (``gmres``: restarts)
#: and the fall of its residual it must show: the last history entry
#: over the first at most this (``chebyshev``: its 200 steps at this
#: condition number are promised no fall, so its residual must stay under
#: 1.5x the first; S6 keeps no residual)
SOLVES = {
    "S1 cg float32": (1000, 1e-4),
    "S1 cg float32 diag_precond": (1000, 1e-4),
    "S2 cg float64": (1000, 1e-5),
    "S2 cg float64 diag_precond": (1000, 1e-5),
    "S3 bicgstab float32": (200, 1e-4),
    "S3 bicgstab float64": (200, 1e-10),
    "S4 gmres(32) float32": (4, 1e-4),
    "S5 jacobi float32": (200, 1e-3),
    "S5 chebyshev float32": (200, 1.5),
    "S6 lanczos float32": (64, None),
    "S6 power_iteration float32": (200, None),
}
#: the side of the 2-D Laplacian of S1, S2 and S5 (4,194,304 rows)
SOLVER_GRID = 2048
#: relative agreement of a graphed solve with the same solve run eagerly
#: (kernels or plain twins): residual histories over their entries above
#: 1e-4 of the first, and S6's estimates
SOLVE_TOL = {"float32": 1e-3, "float64": 1e-9}


def _loop_ms(solvers):
    """Milliseconds per iteration of the last solver loop on the card,
    from the CUDA events the loop recorded around itself."""
    start, end, iters = solvers._iterate.loop
    end.synchronize()
    return start.elapsed_time(end) / max(iters, 1)


def _busy_per_iter(trace, run, iters):
    """Device busy ms per iteration of ``run(mode, iters)`` in the graphed
    and the eager mode: the profiler's busy time of a solve of
    min(iters, 100) iterations less that of a 1-iteration solve, over the
    difference (set-up, capture warm-up and the final residual cancel).
    None where the profiler saw no device time in the difference."""
    n = min(iters, 100)
    out = {}
    for mode in ("graph", "eager"):
        t_n = trace.device_busy_s(lambda: run(mode, n), calls=1)
        t_1 = trace.device_busy_s(lambda: run(mode, 1), calls=1)
        d = None if t_n is None or t_1 is None else (t_n - t_1) / (n - 1)
        out[mode] = d * 1e3 if d and d > 0 else None
    return out


def _share(v):
    """A share for a text line; None reads "not measured"."""
    return "not measured" if v is None else f"{v:.3f}"


def _rel_agree(a, b):
    """Largest relative difference of ``b`` from ``a`` over the entries
    of ``a`` above 1e-4 of its first."""
    a = a.double().cpu().reshape(-1)
    b = b.double().cpu().reshape(-1)
    live = a.abs() > 1e-4 * a[0].abs()
    if not bool(live.any()):
        return 0.0
    return float(((b[live] - a[live]) / a[live]).abs().max())


def _check_sync_debug(torch, solvers):
    """The sync debug mode the solvers' replays run under does raise on
    a host sync."""
    with solvers._sync_forbidden():
        try:
            torch.ones(1, device="cuda").item()
        except RuntimeError:
            return
    raise AssertionError("set_sync_debug_mode('error') let a host sync "
                         "through")


def solver_phase(torch, card, wrappers, launches, lap, gasym, cant):
    """Phase 7: the solvers at full width on the card, each graphed (the
    public entry point), eagerly with the kernels, and eagerly through the
    appliers' plain twins. ``lap``: {dtype name: (tuned Laplacian, its
    diagonal, b)}; ``gasym``: {dtype name: (tuned general_asym(), b)};
    ``cant``: the tuned ``cant_proxy()``."""
    from cfs_spmv_tpu_torch.models import solvers
    from cfs_spmv_tpu_torch.utils import trace

    g = SOLVER_GRID
    lam_min = 8 * np.sin(np.pi / (2 * (g + 1))) ** 2
    lam_max = 8 * np.cos(np.pi / (2 * (g + 1))) ** 2
    t32, d32, b32 = lap["float32"]
    t64, d64, b64 = lap["float64"]
    n_cant = cant.nrows

    def top_ritz(ab):
        a, b = (t.double().cpu().numpy() for t in ab)
        T = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
        return torch.tensor(np.linalg.eigvalsh(T)[[0, -1]])

    #: name -> (run(mode, iters), expected kernels, dtype name, history
    #: of the output, the estimate S6 compares)
    solves = {
        "S1 cg float32": (lambda m, k: solvers.cg(t32, b32, iters=k, _mode=m),
                          {"sdia_sym"}, "float32"),
        "S1 cg float32 diag_precond": (
            lambda m, k: solvers.cg(t32, b32, iters=k, diag_precond=d32,
                                    _mode=m), {"sdia_sym"}, "float32"),
        "S2 cg float64": (lambda m, k: solvers.cg(t64, b64, iters=k, _mode=m),
                          {"sdia_sym_df"}, "float64"),
        "S2 cg float64 diag_precond": (
            lambda m, k: solvers.cg(t64, b64, iters=k, diag_precond=d64,
                                    _mode=m), {"sdia_sym_df"}, "float64"),
        "S3 bicgstab float32": (
            lambda m, k: solvers.bicgstab(gasym["float32"][0],
                                          gasym["float32"][1], iters=k,
                                          _mode=m), {"sdia_gen"}, "float32"),
        "S3 bicgstab float64": (
            lambda m, k: solvers.bicgstab(gasym["float64"][0],
                                          gasym["float64"][1], iters=k,
                                          _mode=m), {"bell2_spmv_df"},
            "float64"),
        "S4 gmres(32) float32": (
            lambda m, k: solvers.gmres(gasym["float32"][0],
                                       gasym["float32"][1], restart=32,
                                       outer=k, _mode=m), {"sdia_gen"},
            "float32"),
        "S5 jacobi float32": (
            lambda m, k: solvers.jacobi(t32, d32, b32, iters=k, omega=0.8,
                                        _mode=m), {"sdia_sym"}, "float32"),
        "S5 chebyshev float32": (
            lambda m, k: solvers.chebyshev(t32, b32, lam_min, lam_max,
                                           iters=k, _mode=m), {"sdia_sym"},
            "float32"),
        "S6 lanczos float32": (
            lambda m, k: solvers.lanczos(cant, n_cant, iters=k, _mode=m),
            {"sdia_sym"}, "float32"),
        "S6 power_iteration float32": (
            lambda m, k: solvers.power_iteration(cant, n_cant, iters=k,
                                                 _mode=m),
            {"sdia_sym"}, "float32"),
    }
    _check_sync_debug(torch, solvers)
    said = {}
    estimates = {}
    for name, (run, kernels, dt) in solves.items():
        iters, fall = SOLVES[name]
        for w in wrappers.values():
            w.launches = 0
        with trace.recording():
            out_g = run("graph", iters)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        replays = trace.collect().counters.get("solve.replays", 0)
        wall_g = _loop_ms(solvers)
        for k, c in counts.items():
            launches[k] += c
        out_e = run("eager", iters)
        wall_e = _loop_ms(solvers)
        out_p = run("plain", iters)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, b) for a, b in zip(out_g, out_e))
        if name.startswith("S6 lanczos"):
            est = [top_ritz(o) for o in (out_g, out_e, out_p)]
            estimates["lanczos"] = est[0]
            hist = None
        elif name.startswith("S6 power"):
            est = [o[1].reshape(1) for o in (out_g, out_e, out_p)]
            estimates["power"] = est[0]
            hist = None
        else:
            hist = [o[2] if len(o) == 3 else o[1] for o in (out_g, out_e,
                                                            out_p)]
            est = hist
        tol = SOLVE_TOL[dt]
        dev_e = _rel_agree(est[0], est[1])
        dev_p = _rel_agree(est[0], est[2])
        # x: the largest difference over the largest entry
        x_p = (float((out_p[0] - out_g[0]).abs().max()
                     / out_g[0].abs().max()) if hist is not None else 0.0)
        finite = all(bool(torch.isfinite(t).all()) for t in out_g)
        drop = float(hist[0][-1] / hist[0][0]) if hist is not None else None
        busy = _busy_per_iter(trace, run, iters)
        idle = {m: (None if busy[m] is None else 1 - busy[m] / w)
                for m, w in (("graph", wall_g), ("eager", wall_e))}
        said[name] = dict(wall_g=wall_g, wall_e=wall_e, busy=busy, idle=idle,
                          replays=replays)
        print(
            f"solver {name}: {iters} iterations, {replays} graph replays; "
            f"wall per iteration graphed {wall_g:.4f} ms, eager "
            f"{wall_e:.4f} ms; device busy per iteration graphed "
            f"{_ms(busy['graph'])} ms, eager {_ms(busy['eager'])} ms; idle "
            f"share graphed {_share(idle['graph'])}, eager "
            f"{_share(idle['eager'])}; "
            f"graphed bit-identical to eager: {identical}; max relative "
            f"difference graphed vs eager {dev_e:.3g}, vs plain twins "
            f"{dev_p:.3g} (x {x_p:.3g}), tolerance {tol}; "
            + (f"residual {float(hist[0][0]):.4g} -> {float(hist[0][-1]):.4g} "
               f"(fall {drop:.3g}, must be <= {fall}); "
               if hist is not None else
               f"estimate {est[0].tolist()}; ")
            + f"launched {counts} ({card})", flush=True)
        if not finite:
            raise AssertionError(f"{name}: the graphed solve is not finite")
        if set(counts) != kernels:
            raise AssertionError(f"{name}: launched {sorted(counts)}, "
                                 f"expected {sorted(kernels)}")
        if replays != iters:
            raise AssertionError(f"{name}: {replays} graph replays for "
                                 f"{iters} iterations")
        if max(dev_e, dev_p, x_p) > tol:
            raise AssertionError(f"{name}: the graphed solve disagrees with "
                                 "its eager runs")
        if drop is not None and not drop <= fall:
            raise AssertionError(f"{name}: the residual fell by {drop:.3g}, "
                                 f"not to {fall}")
    top = float(estimates["lanczos"][1])
    lam = float(estimates["power"][0])
    print(f"solver S6: power estimate {lam:.6g} against the top Ritz value "
          f"{top:.6g}, relative difference {abs(lam / top - 1):.3g} "
          f"(within {SOLVE_TOL['float32']})", flush=True)
    if abs(lam / top - 1) > SOLVE_TOL["float32"]:
        raise AssertionError("S6: power iteration and Lanczos disagree")
    return said


#: phase 8's cases (``parallel/dist.DistSpDMV`` on ``make_mesh(P,
#: device="cuda:0")``): name -> (matrix, P, DistSpDMV keywords,
#: environment, the single-device run of the same matrix and type (phase
#: 3's, or built in phase 8), SpMM(8) too)
DIST_CASES = {
    "D1 cant_proxy P=1": ("cant", 1, {}, {}, "cant_proxy", False),
    "D1 cant_proxy P=2": ("cant", 2, {}, {}, "cant_proxy", False),
    "D1 cant_proxy P=4": ("cant", 4, {}, {}, "cant_proxy", True),
    # shards past the diagonal gate: mirrored planes (B6, B12)
    "D1 cant_proxy P=4 mirrored": (
        "cant", 4, {}, {"CFS_DIST_SDIA_ROWS_MAX": "8192"}, "cant_proxy",
        True),
    # auto resolves to halo: audikw_proxy()'s blocks lie within 300 block
    # rows of the diagonal, a window of 1,024 rows
    "D2 audikw_proxy P=4": ("audikw", 4, {}, {}, "audikw_proxy", True),
    "D2 audikw_proxy P=4 gather": ("audikw", 4, dict(comm="gather"), {},
                                   "audikw_proxy", False),
    "D2 audikw_proxy P=4 ring": ("audikw", 4, dict(comm="ring"), {},
                                 "audikw_proxy", True),
    "D3 general_asym P=4": ("gasym", 4, {}, {}, "general_asym", False),
    "D4 stencil27 P=4 ring": ("st27", 4, dict(comm="ring"), {},
                              "stencil27", False),
    # the default gate pairs no shard of D1-D4: the paired stream (B5,
    # B10) runs where pairing is forced, as phase 3's run of the matrix
    "D5 near_band_paired P=4 paired": (
        "nbp", 4, {}, {"CFS_PAIRED": "force"}, "near_band_paired", True),
    # float64 (``dtype=np.float64``): the union diagonals in double
    # (B13/B14) and the far grids (B15/B16); mirrored: the signed
    # diagonals' double instance (B6/B12); forced pairing: the paired
    # stream's (B5/B10), its residual as double entries; general_asym: the
    # far grids alone
    "D1 cant_proxy P=4 float64": (
        "cant", 4, dict(dtype=np.float64), {}, "cant_proxy_f64", True),
    "D1 cant_proxy P=4 mirrored float64": (
        "cant", 4, dict(dtype=np.float64),
        {"CFS_DIST_SDIA_ROWS_MAX": "8192"}, "cant_proxy_f64", True),
    "D5 near_band_paired P=4 paired float64": (
        "nbp", 4, dict(dtype=np.float64), {"CFS_PAIRED": "force"},
        "near_band_paired_f64", True),
    "D3 general_asym P=4 float64": (
        "gasym", 4, dict(dtype=np.float64), {}, "general_asym_f64", True),
}
#: graphed cg iterations over the 4-shard operator of D1's matrix
DIST_CG_ITERS = 100


def predict_dist(dsp, planes=0) -> dict:
    """{kernel: launches} an apply of the distributed operator ``dsp``
    makes, read off its shards' device structs (the branches of
    ``parallel/dist.DistSpDMV._shard_apply`` and, for the near part,
    ``ops/spmv.sbell_apply``; a float64 operator runs ``F64_OF``'s
    kernels); ``planes`` = B > 0 for the SpMM apply, whose stream kernels
    launch once per group of 8 planes (the double paired kernel too,
    since it holds 8 planes in dynamic shared memory). A process-group
    operator launches its own shard's only."""
    import torch

    from cfs_spmv_tpu_torch.ops import _cuda

    mm = planes > 0
    f64 = dsp.dtype == torch.float64
    out = {}

    def add(name):
        name = F64_OF[name] if f64 else name
        name = MM_OF[name] if mm else name
        out[name] = out.get(name, 0) + (-(-planes // _cuda.RHS_GROUP)
                                        if mm else 1)

    for sh in dsp.shards:
        if sh is None:
            continue
        near = sh.near
        if near is not None:
            if near.has_paired:
                add("sbell_spmv")
            if near.far is not None and near.far.entries.count:
                # a float32 shard of entries alone: one pass with D x
                rows = (not mm and not f64 and near.far_rows is not None
                        and not near.has_paired and near.dia_vals is None)
                add("bell2_entries_rows" if rows else "bell2_spmv_accum")
            if near.dia_vals is not None:
                add("sdia_gen" if near.dia_mirrored else "sdia_sym")
        if sh.far is not None and sh.far.has_work:
            add("bell2_spmv")
        for st in sh.ring or ():
            if st.has_work and st.entries.count:
                add("bell2_spmv_accum")
    return out


@contextlib.contextmanager
def _env(values):
    """The environment variables ``values`` set, restored afterwards."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: phase 9's cases: one NCCL rank (the card's machine has one card, and
#: NCCL takes one rank a card) applies ``DistSpDMV`` over the process-group
#: mesh of ``make_mesh()`` after ``multihost.initialize``, beside the
#: single-process operator on card 0: name -> (matrix, keywords)
NCCL_CASES = {
    "cant_proxy float32": ("cant", {}),
    "cant_proxy float64": ("cant", dict(dtype=np.float64)),
    "cant_proxy float32 ring": ("cant", dict(comm="ring")),
    "general_asym float64": ("gasym", dict(dtype=np.float64)),
}
#: seconds phase 9's rank may take
NCCL_TIMEOUT = 600


def nccl_rank(out_path) -> int:
    """Phase 9's rank (``chip_smoke.py --nccl-rank <out>``): joins a NCCL
    process group of one rank (``multihost.initialize`` with an explicit
    ``tcp://localhost`` address), applies each ``NCCL_CASES`` operator
    over ``make_mesh()`` (launches counted against ``predict_dist``) and
    the single-process operator on card 0 to one x and to X of ``RHS``
    columns, holds the two to each other (``_agree``) and the SpMV to the
    float64 oracle at the type's gate, times both graphed
    (``time_matvec``: the all-gather captured in the graph) and by
    device time, prints a line each, and writes its launch counts to
    ``out_path``."""
    import socket

    import torch
    import torch.distributed as dist

    from cfs_spmv_tpu_torch.parallel import multihost
    from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
    from cfs_spmv_tpu_torch.parallel.mesh import Mesh, make_mesh
    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
    from cfs_spmv_tpu_torch.utils.proxies import cant_proxy, general_asym
    from cfs_spmv_tpu_torch.utils.timing import time_matvec

    card = _card()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize(init_method=f"tcp://localhost:{port}", rank=0,
                         world_size=1)
    mesh = make_mesh()
    dev = mesh.devices[0]
    print(f"nccl rank: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, mesh {mesh.shape} on {dev}, rank "
          f"{mesh.rank}", flush=True)
    if mesh.group is None or mesh.single_device or \
            dist.get_backend() != "nccl":
        raise AssertionError("make_mesh() after initialize() is not a NCCL "
                             "process-group mesh")
    wrappers = _wrappers()
    launches = dict.fromkeys(wrappers, 0)
    mats = {"cant": cant_proxy(), "gasym": general_asym()}
    for name, (mat, kw) in NCCL_CASES.items():
        csr = mats[mat]
        dt = np.dtype(kw.get("dtype", np.float32))
        grp = DistSpDMV(csr, mesh, **kw)
        one = DistSpDMV(csr, Mesh((dev,)), **kw)
        rng = np.random.default_rng(1)
        x = rng.uniform(1.0, 2.0, csr.ncols).astype(dt)
        X = rng.uniform(1.0, 2.0, (csr.ncols, RHS)).astype(dt)
        for what, arg, B in (("SpMV", x, 0), (f"SpMM({RHS})", X, RHS)):
            at = torch.as_tensor(arg, device=dev)
            for w in wrappers.values():
                w.launches = 0
            y = grp(at)
            torch.cuda.synchronize()
            counts = {k: w.launches for k, w in wrappers.items()
                      if w.launches}
            for k, c in counts.items():
                launches[k] += c
            want = predict_dist(grp, B)
            y1 = one(at)
            xd = arg.astype(np.float64)
            scale = (np.stack([csr.spmv_host(xd[:, b], absolute=True)
                               for b in range(B)], 1) if B
                     else csr.spmv_host(xd, absolute=True))
            npr = grp.nnz_full / csr.nrows
            err = _agree(y, y1, torch.as_tensor(scale), npr,
                         f"nccl {name} {what}")
            ok = B or allclose_spmv(y.cpu().numpy(), csr.spmv_host(xd), dt,
                                    nnz_per_row=npr, scale=scale)
            iters = GRAPH_ITERS // 4 if B else GRAPH_ITERS
            t_g = time_matvec(grp, at, iters=iters) * 1e3
            t_1 = time_matvec(one, at, iters=iters) * 1e3
            d_g, by = _device_ms(torch, lambda: grp(at))
            d_1, _ = _device_ms(torch, lambda: one(at))
            print(f"nccl {name} {what}: comm {grp.comm}, shard rows "
                  f"{grp.shard_rows}; predicted {want} launched {counts}; "
                  f"against the single-process operator max_abs_err {err}, "
                  f"bit-identical {bool(torch.equal(y, y1))}"
                  + ("" if B else f"; oracle_ok {ok}")
                  + f"; per apply graphed {t_g:.4f} ms (single process "
                  f"{t_1:.4f}), device {_ms(d_g)} ms "
                  f"({_fmt_device(d_g, by)}; single process {_ms(d_1)}) "
                  f"({card})", flush=True)
            if counts != want or not ok:
                raise AssertionError(f"nccl {name} {what}: launched "
                                     f"{counts}, predicted {want}, oracle "
                                     f"{ok}")
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"launches": launches}, f)
    return 0


def _single_run(csr, dtype):
    """(SparseMatrix tuned on the card in ``dtype``, x) of a single-device
    run phase 3 does not make, as phase 3 makes them."""
    from cfs_spmv_tpu_torch import Format, SparseMatrix, SpDMV, Tuning

    A = SparseMatrix.create(csr, Format.SSS if csr.symmetric else Format.CSR)
    SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype)
    x = np.random.default_rng(1).uniform(1.0, 2.0, csr.ncols).astype(dtype)
    return A, x


def dist_phase(torch, card, counted, oracle_ok, mats, runs, wrappers,
               launches, prebuilt):
    """Phase 8: ``DistSpDMV`` on P shards of card 0 (``DIST_CASES``), each
    apply (SpMV, and SpMM(8) where the case says) counted against its
    shards' prediction and held to the float64 oracle at its type's gate,
    to its plain twins' path and to the single-device apply of its type;
    its graphed and device time per apply beside the single-device
    apply's; then S1 cg graphed over D1's 4-shard operator against its
    eager run. ``prebuilt``: operators phase 4 built, by case."""
    from cfs_spmv_tpu_torch.models import solvers
    from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
    from cfs_spmv_tpu_torch.parallel.mesh import make_mesh
    from cfs_spmv_tpu_torch.utils import trace
    from cfs_spmv_tpu_torch.utils.timing import time_matvec

    dev = torch.device("cuda", 0)
    ops4 = None
    for name, (mat, P, kw, env, run, with_mm) in DIST_CASES.items():
        csr = mats[mat]
        dt = np.dtype(kw.get("dtype", np.float32))
        if run not in runs:
            runs[run] = _single_run(csr, dt)
        A1, x = runs[run]
        t0 = time.perf_counter()
        if name in prebuilt:
            dsp = prebuilt[name]
        else:
            with _env(env):
                dsp = DistSpDMV(csr, make_mesh(P, device="cuda:0"), **kw)
        t_plan = time.perf_counter() - t0
        xt = torch.as_tensor(x, device=dev)
        want = predict_dist(dsp)
        y, counts = counted(lambda: dsp(xt))
        got = {k: c for k, c in counts.items() if c}
        ok, err, scaled = oracle_ok(y.cpu().numpy(), csr,
                                    x.astype(np.float64), dsp.nnz_full, dt)
        fn, shards = dsp.pure_apply()
        y_plain = fn(shards, xt, plain=True)
        scale = torch.as_tensor(csr.spmv_host(x.astype(np.float64),
                                              absolute=True))
        npr = dsp.nnz_full / csr.nrows
        err_plain = _agree(y, y_plain, scale, npr, f"{name} against twins")
        y1 = A1.tuned.matvec(xt)
        err_one = _agree(y, y1, scale, npr, f"{name} against one device")
        t_g = time_matvec(dsp, xt, iters=GRAPH_ITERS) * 1e3
        # the timer of a mesh over several cards, here on one
        t_e = time_matvec(dsp, xt, iters=TIMED_CALLS, graph=False) * 1e3
        d_ms, by_name = _device_ms(torch, lambda: dsp(xt))
        t1_g = time_matvec(A1.tuned, xt, iters=GRAPH_ITERS) * 1e3
        d1_ms, _ = _device_ms(torch, lambda: A1.tuned.matvec(xt))
        print(
            f"dist {name}: {dt.name} n={csr.nrows} nnz_full={dsp.nnz_full} "
            f"comm={dsp.comm} halo_rows={dsp.halo_rows} shard_rows="
            f"{dsp.shard_rows} BT={dsp.BT} K={dsp.K} real={dsp.real} "
            f"dia={len(getattr(dsp, 'dia_offsets', ()))} "
            f"mirror={getattr(dsp, 'dia_mirror', False)} far_fraction="
            f"{dsp.far_fraction:.4f}; "
            + ("planned and uploaded in phase 4" if name in prebuilt else
               f"planned and uploaded in {t_plan:.2f} s")
            + f"; predicted {want} launched {got}; max_abs_err={err} "
            f"max_scaled_err={scaled} oracle_ok={ok}; against the twins' "
            f"path {err_plain}, against the single-device apply {err_one}; "
            f"per apply graphed {t_g:.4f} ms, eager {t_e:.4f} ms, device "
            f"{_ms(d_ms)} ms ({_fmt_device(d_ms, by_name)}); single device "
            f"graphed {t1_g:.4f} ms, device {_ms(d1_ms)} ms ({card})",
            flush=True)
        if got != want:
            raise AssertionError(f"{name}: launched {got}, its shards "
                                 f"predict {want}")
        if not ok:
            raise AssertionError(f"{name}: disagrees with the oracle")
        if with_mm:
            X = np.random.default_rng(2).uniform(
                1.0, 2.0, (csr.ncols, RHS)).astype(dt)
            Xt = torch.as_tensor(X, device=dev)
            want_mm = predict_dist(dsp, RHS)
            Y, counts = counted(lambda: dsp(Xt))
            got_mm = {k: c for k, c in counts.items() if c}
            worst = 0.0
            for b in range(RHS):
                ok_b, _, s_b = oracle_ok(
                    Y[:, b].cpu().numpy(), csr, X[:, b].astype(np.float64),
                    dsp.nnz_full, dt)
                if not ok_b:
                    raise AssertionError(f"{name} SpMM: column {b} "
                                         "disagrees with the oracle")
                worst = max(worst, s_b)
            t_mm = time_matvec(dsp, Xt, iters=GRAPH_ITERS // 4) * 1e3
            dmm, by_mm = _device_ms(torch, lambda: dsp(Xt))
            t1_mm = time_matvec(A1.tuned, Xt, iters=GRAPH_ITERS // 4) * 1e3
            d1_mm, _ = _device_ms(torch, lambda: A1.tuned.matmat(Xt))
            print(
                f"dist {name} SpMM({RHS}): predicted {want_mm} launched "
                f"{got_mm}; max_scaled_err={worst}; per apply graphed "
                f"{t_mm:.4f} ms, device {_ms(dmm)} ms "
                f"({_fmt_device(dmm, by_mm)}); single device graphed "
                f"{t1_mm:.4f} ms, device {_ms(d1_mm)} ms ({card})",
                flush=True)
            if got_mm != want_mm or set(got_mm) & set(MM_OF):
                raise AssertionError(f"{name} SpMM: launched {got_mm}, its "
                                     f"shards predict {want_mm}")
        if name == "D1 cant_proxy P=4":
            ops4 = dsp
    # S1 cg over the 4-shard operator, graphed against its eager run
    b = ops4(torch.as_tensor(np.random.default_rng(0).standard_normal(
        ops4.nrows).astype(np.float32), device=dev))
    want = set(predict_dist(ops4))  # launched while capturing, not replays
    for w in wrappers.values():
        w.launches = 0
    with trace.recording():
        out_g = solvers.cg(ops4, b, iters=DIST_CG_ITERS)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items() if w.launches}
    for k, c in counts.items():
        launches[k] += c
    replays = trace.collect().counters.get("solve.replays", 0)
    wall_g = _loop_ms(solvers)
    out_e = solvers.cg(ops4, b, iters=DIST_CG_ITERS, _mode="eager")
    wall_e = _loop_ms(solvers)
    h_g, h_e = out_g[2], out_e[2]
    identical = all(torch.equal(p, q) for p, q in zip(out_g, out_e))
    dev_e = _rel_agree(h_g, h_e)
    fall = float(h_g[-1] / h_g[0])
    print(f"dist S1 cg float32 over D1's 4-shard operator: {DIST_CG_ITERS} "
          f"iterations, {replays} graph replays; wall per iteration graphed "
          f"{wall_g:.4f} ms, eager {wall_e:.4f} ms; graphed bit-identical to "
          f"eager: {identical}; max relative history difference {dev_e:.3g} "
          f"(tolerance {SOLVE_TOL['float32']}); residual {float(h_g[0]):.4g} "
          f"-> {float(h_g[-1]):.4g}; launched {counts} ({card})", flush=True)
    if replays != DIST_CG_ITERS or set(counts) != want:
        raise AssertionError(f"dist S1: {replays} replays for "
                             f"{DIST_CG_ITERS} iterations, launched "
                             f"{sorted(counts)}, expected {sorted(want)}")
    if (dev_e > SOLVE_TOL["float32"] or not fall < 1
            or not all(bool(torch.isfinite(t).all()) for t in out_g)):
        raise AssertionError("dist S1: the graphed solve disagrees with its "
                             "eager run, or its residual did not fall")


#: HPCG's 27-point stencil on a 256^3 grid (the benchmark's hpcg-256):
#: rows, and its 14 lower diagonals' offsets, the main one first
HPCG_ROWS = 256 ** 3
HPCG_OFFSETS = tuple(sorted({dz * 65536 + dy * 256 + dx
                             for dz in (0, 1) for dy in (-1, 0, 1)
                             for dx in (-1, 0, 1)
                             if dz * 65536 + dy * 256 + dx >= 0}))


def hpcg_rows_phase(torch) -> dict:
    """The float64 SpMM of a diagonal-only plan at hpcg-256's shape
    (16,777,216 rows, 14 lower diagonals, random planes and a random
    row-major X of 8 columns): ``sdia_sym_rows_df_mm`` against its twin
    and against B14 over planes, then in turns (row-major, planes,
    planes, row-major) the device ms of one launch of it and of the
    planes composition it replaced (``pad_x_mm``'s zeroed planes and
    transposing copy, the zeroed output, B14), by kernel, and their
    event ms. Returns the times."""
    from cfs_spmv_tpu_torch.ops import sdia_df as sdf
    from cfs_spmv_tpu_torch.ops import spmv as ops

    dev = torch.device("cuda")
    f64 = torch.float64
    n, TD = HPCG_ROWS, HPCG_ROWS // 128
    g = torch.Generator(device=dev).manual_seed(24)
    vals = torch.rand((n // 1024, len(HPCG_OFFSETS), 8, 128), generator=g,
                      dtype=f64, device=dev).sub_(0.5)
    offs = torch.tensor(HPCG_OFFSETS, dtype=torch.int32, device=dev)
    X = torch.rand((n, RHS), generator=g, dtype=f64, device=dev).sub_(0.5)
    t = torch.full((n * RHS,), float("nan"), dtype=f64, device=dev)
    del t  # the wrapper's Y takes this block: an unwritten row stays NaN
    Y = sdf.sdia_sym_rows_df_mm(vals, X, offs)
    scale = sdf.sdia_sym_rows_plain(vals.abs(), X.abs(), offs)
    err = _agree(Y, sdf.sdia_sym_rows_plain(vals, X, offs), scale,
                 2 * len(HPCG_OFFSETS), "sdia_sym_rows_df_mm at hpcg-256")

    def planes():
        return sdf.sdia_sym_tiles_df_mm(
            vals, ops.pad_x_mm(X, TD), ops._zeros(X, (RHS, TD, 128)), offs)

    Yp = planes().reshape(RHS, -1)[:, :n].T
    err_p = _agree(Y, Yp, scale, 2 * len(HPCG_OFFSETS),
                   "sdia_sym_rows_df_mm against B14 over planes")
    del Y, Yp, scale
    torch.cuda.empty_cache()
    forms = {"rows": lambda: sdf.sdia_sym_rows_df_mm(vals, X, offs),
             "planes": planes}
    times = {k: {"device_ms": [], "event_ms": [], "by_kernel": {}}
             for k in forms}
    for k in ("rows", "planes", "planes", "rows"):
        busy, by = _device_ms(torch, forms[k], calls=5)
        times[k]["device_ms"].append(busy)
        times[k]["by_kernel"] = by
        times[k]["event_ms"].append(_median_ms(torch, forms[k], calls=5,
                                               repeats=3))
    bound = _bound(_nbytes(vals, X) + _nbytes(X),
                   RHS * 4 * int(torch.count_nonzero(vals)), "float64")[0]
    said = "; ".join(
        f"{k}: device ms in turns {v['device_ms']}, last "
        f"{_fmt_device(v['device_ms'][-1], v['by_kernel'])}, event ms "
        f"{v['event_ms']}" for k, v in times.items())
    print(f"hpcg-256 SpMM({RHS}) over a row-major X: {n} rows, offsets "
          f"{list(HPCG_OFFSETS)}; max_abs_err vs twin {err}, vs B14 over "
          f"planes {err_p}; {said}; bound {bound:.4f} ms", flush=True)
    del vals, X, forms
    torch.cuda.empty_cache()
    return dict(times, bound_ms=bound, err=err, err_planes=err_p)


def _wrappers() -> dict:
    """{kernel: its wrapper's count}: every wrapper of the port, and the
    bf16 and float64 instances counted apart."""
    from cfs_spmv_tpu_torch.ops import bell2_df as bdf
    from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
    from cfs_spmv_tpu_torch.ops import sdia_df as sdf
    from cfs_spmv_tpu_torch.ops import sdia_kernel as sk

    wrappers = {
        "sdia_sym": sk.sdia_sym_tiles,
        "bell2_spmv": bk.bell2_spmv_tiles,
        "bell2_spmv_accum": bk.bell2_spmv_tiles_accum,
        "bell2_entries_rows": bk.bell2_entries_rows,
        "unperm_gather": bk.unperm_gather_tiles,
        "sbell_spmv": bk.sbell_spmv_tiles,
        "sdia_gen": sk.sdia_gen_tiles,
        "sdia_sym_mm": sk.sdia_sym_tiles_mm,
        "bell2_spmm": bk.bell2_spmm_tiles,
        "bell2_spmm_accum": bk.bell2_spmm_tiles_accum,
        "unperm_gather_mm": bk.unperm_gather_tiles_mm,
        "sbell_spmm": bk.sbell_spmm_tiles,
        "sdia_gen_mm": sk.sdia_gen_tiles_mm,
        "sdia_sym_df": sdf.sdia_sym_tiles_df,
        "sdia_sym_df_mm": sdf.sdia_sym_tiles_df_mm,
        "sdia_sym_rows_df_mm": sdf.sdia_sym_rows_df_mm,
        "bell2_spmv_df": bdf.bell2_spmv_tiles_df,
        "bell2_spmm_df": bdf.bell2_spmm_tiles_df,
        "bell2_spmv_accum_df": bdf.bell2_spmv_tiles_accum_df,
        "bell2_spmm_accum_df": bdf.bell2_spmm_tiles_accum_df,
    }
    wrappers.update({f"{k}_bf16": _Count(wrappers[k], "bf16")
                     for k in BF16_KERNELS})
    wrappers.update({f"{k}_f64": _Count(wrappers[k], "f64")
                     for k in F64_KERNELS})
    return wrappers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cfs_spmv_tpu_torch import (CSR, Format, SparseMatrix, SpDMM, SpDMV,
                                    Tuning)
    from cfs_spmv_tpu_torch.cli.test_spmv_mmf import main as test_cli
    from cfs_spmv_tpu_torch.formats.bell2 import build_general_plan
    from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
    from cfs_spmv_tpu_torch.io.mmf import write_mmf
    from cfs_spmv_tpu_torch.formats.bell2 import (build_bell2_from_arrays,
                                                  build_bell2_plan)
    from cfs_spmv_tpu_torch.formats.coo import COO
    from cfs_spmv_tpu_torch.ops import _cuda
    from cfs_spmv_tpu_torch.ops import bell2_df as bdf
    from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
    from cfs_spmv_tpu_torch.ops import sdia_df as sdf
    from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
    from cfs_spmv_tpu_torch.ops import spmv as ops
    from cfs_spmv_tpu_torch.tuning.tune import tune
    from cfs_spmv_tpu_torch.utils.config import config
    from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
    from cfs_spmv_tpu_torch.utils import trace
    from cfs_spmv_tpu_torch.utils.timing import capture, time_matvec
    from cfs_spmv_tpu_torch.utils.proxies import (
        audikw_proxy,
        cant_proxy,
        general_asym,
        near_band_paired,
        stencil27,
    )

    wrappers = _wrappers()
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
    # ptxas' report builds beside the port's own library
    ptxas = ptxas_start()
    _cuda.lib()
    phase_done("2 kernel build/load")
    regs = ptxas_report(_nvcc_wait(ptxas,
                                   "the kernel source with -Xptxas -v"))
    print(f"ptxas: {len(regs)} entry functions; registers per thread "
          f"(+ spill bytes): {_regs_line(regs)}", flush=True)
    if any(v[1] for v in regs.values()):
        raise AssertionError("ptxas reports spills (see the line above)")
    phase_done("2b ptxas report")

    t0 = time.perf_counter()
    cant = cant_proxy()
    flag = flagship(n=65536, deg=32)
    nbp = near_band_paired()
    nbp400 = near_band_paired(n=400_000)
    audikw = audikw_proxy()
    gasym = general_asym()
    st27 = stencil27()
    #: name -> (CSR, format, tuning, CFS_PAIRED, SDIA_SYM_ROWS_MAX); the
    #: float64 runs (the names ending in _f64) follow their float32 runs
    RUNS = {
        "cant_proxy": (cant, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "audikw_proxy": (audikw, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "flagship": (flag, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "general_asym": (gasym, Format.CSR, Tuning.AGGRESSIVE, None, None),
        "flagship_csr": (flag, Format.CSR, Tuning.AGGRESSIVE, None, None),
        "cant_proxy_none": (cant, Format.SSS, Tuning.NONE, None, None),
        "near_band_paired": (nbp, Format.SSS, Tuning.AGGRESSIVE, "force",
                             None),
        "near_band_paired_auto": (nbp, Format.SSS, Tuning.AGGRESSIVE,
                                  "auto", None),
        "cant_proxy_mirrored": (cant, Format.SSS, Tuning.AGGRESSIVE, None,
                                cant.nrows - 1),
        "near_band_paired_400k": (nbp400, Format.SSS, Tuning.AGGRESSIVE,
                                  "force", None),
        "near_band_paired_400k_auto": (nbp400, Format.SSS,
                                       Tuning.AGGRESSIVE, "auto", None),
        "stencil27": (st27, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "cant_proxy_f64": (cant, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "audikw_proxy_f64": (audikw, Format.SSS, Tuning.AGGRESSIVE, None,
                             None),
        "flagship_f64": (flag, Format.SSS, Tuning.AGGRESSIVE, None, None),
        "general_asym_f64": (gasym, Format.CSR, Tuning.AGGRESSIVE, None,
                             None),
        "stencil27_f64": (st27, Format.SSS, Tuning.AGGRESSIVE, None, None),
    }
    print(f"matrices generated in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 3. the main paths, once each -----------------------------------
    launches = dict.fromkeys(wrappers, 0)
    runs = {}
    scaled = {}  # run -> worst scaled error of its SpMV apply

    def counted(fn):
        """Run ``fn`` with every launch count at 0 before and read after;
        returns (result, {kernel: launches}) and adds to the totals."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, c in counts.items():
            launches[k] += c
        return out, counts

    oracle = {}  # (matrix, x) -> (A x, |A| |x|): runs share matrices

    def oracle_ok(y_np, csr, xd, nnz_full, dtype):
        """(agrees with the float64 host oracle at ``dtype``'s gate, max
        abs error, max error scaled by |A| |x|)."""
        key = (id(csr), hashlib.sha1(xd).digest())
        if key not in oracle:
            oracle[key] = (csr.spmv_host(xd),
                           csr.spmv_host(xd, absolute=True))
        ref, scale = oracle[key]
        ok = (y_np.shape == (csr.nrows,) and np.isfinite(y_np).all()
              and allclose_spmv(y_np, ref, dtype,
                                nnz_per_row=nnz_full / csr.nrows,
                                scale=scale))
        err = np.abs(y_np - ref)
        return ok, float(err.max()), float(
            (err / np.maximum(scale, 1e-300)).max())

    for name, (csr, fmt, tuning, paired, rows_max) in RUNS.items():
        dtype = np.float64 if name.endswith("_f64") else np.float32
        t0 = time.perf_counter()
        with _planning(paired, rows_max):
            A = SparseMatrix.create(csr, fmt)
            op = SpDMV(A, tuning, dtype=dtype)  # the default device
            op_mm = SpDMM(A, tuning, dtype=dtype)
        t_tune = time.perf_counter() - t0
        predicted = predict(A.tuned)
        x = np.random.default_rng(1).uniform(1.0, 2.0, csr.ncols).astype(
            dtype
        )
        y, counts = counted(lambda: op(x))
        moved = {k for k, c in counts.items() if c}
        y_np = y.cpu().numpy()
        if y_np.dtype != dtype:
            raise AssertionError(f"{name}: result is {y_np.dtype}")
        ok, err, scaled[name] = oracle_ok(
            y_np, csr, x.astype(np.float64), A.tuned.nnz_full, dtype)
        plan = A.tuned.plan
        far = getattr(plan, "far", None)
        print(
            f"main path {name}: n={csr.nrows} nnz_full={A.tuned.nnz_full} "
            f"{fmt.name}/{tuning.name} {np.dtype(dtype).name} "
            f"tune+upload {t_tune:.2f} s "
            f"reorder={A.tuned.perm is not None} "
            f"dia={None if plan.dia is None else len(plan.dia.offsets)} "
            f"paired_nnz={getattr(plan, 'nnz_paired', 0)} "
            f"tw={getattr(plan, 'transpose_windows', None)} "
            f"stream_nnz={getattr(plan, 'nnz', 0)} "
            f"far_nnz={0 if far is None else far.nnz} "
            f"predicted={sorted(predicted)} "
            f"launched={ {k: c for k, c in counts.items() if c} } "
            f"max_abs_err={err} max_scaled_err={scaled[name]} "
            f"oracle_ok={ok}",
            flush=True,
        )
        if dtype == np.float64:
            d64 = A.tuned.operands
            if d64.entries is not None:
                e64 = d64.entries
                mb_e = _nbytes(e64.rows, e64.cols, e64.vals) / 1e6
                stream = f"{mb_e:.2f} MB of entries (16 B each, no grid)"
            else:
                mb_s = (_nbytes(d64.vals, d64.packed, d64.meta) / 1e6
                        if d64.has_work else 0.0)
                stream = (f"{mb_s:.2f} MB (values 8 B + words 2 B a slot, "
                          f"grouped={d64.grouped}, covers={d64.covers})")
            mb_d = (_nbytes(d64.dia_vals) / 1e6
                    if d64.dia_vals is not None else 0.0)
            print(
                f"main path {name}: float64 operands on the card: stream "
                f"{stream}, diagonal planes {mb_d:.2f} MB; "
                f"max scaled error float64 {scaled[name]} against float32 "
                f"{scaled[name[:-4]]} on the same matrix", flush=True)
        if predicted & {"bell2_spmv_accum", "bell2_spmv_accum_df"}:
            acc = far if far is not None else plan  # the host chunk grid
            dacc = A.tuned.operands
            dacc = dacc["dev"] if isinstance(dacc, dict) else dacc
            es = getattr(dacc, "far", None) or dacc
            es = es.entries
            if es is None or es.vals.device.type != "cuda":
                raise AssertionError(f"{name}: no entry list on the card")
            slots = acc.vals.size
            grid_b = acc.vals.nbytes + acc.packed.nbytes
            per = _nbytes(es.rows, es.cols, es.vals) // es.count
            print(
                f"main path {name}: accumulating stream {acc.meta.shape[0]} "
                f"chunks, {slots} slots, {es.count} live entries, fill "
                f"{es.count / slots:.4%}; chunk grid {grid_b / 1e6:.2f} MB "
                f"(not uploaded) against {per * es.count / 1e6:.3f} MB of "
                f"entries at {per} B, {grid_b / (per * es.count):.1f}x",
                flush=True)
        if not ok:
            raise AssertionError(f"{name}: disagrees with the f64 oracle")
        if not moved == predicted == EXPECTED[name]:
            raise AssertionError(
                f"{name}: launched {sorted(moved)}, predicted "
                f"{sorted(predicted)}, expected {sorted(EXPECTED[name])}"
            )
        # SpMM(8) through SpDMM on the same tuned matrix
        X = np.random.default_rng(2).uniform(
            1.0, 2.0, (csr.ncols, RHS)).astype(dtype)
        predicted_mm = predict_mm(A.tuned)
        Y, counts = counted(lambda: op_mm(X))
        moved = {k for k, c in counts.items() if c}
        Y_np = Y.cpu().numpy()
        errs, ok = [], Y_np.shape == (csr.nrows, RHS) and Y_np.dtype == dtype
        for b in range(RHS if ok else 0):
            ok_b, err, _ = oracle_ok(Y_np[:, b], csr,
                                     X[:, b].astype(np.float64),
                                     A.tuned.nnz_full, dtype)
            errs.append(err)
            ok = ok and ok_b
        print(
            f"main path {name} SpMM({RHS}): predicted={sorted(predicted_mm)} "
            f"launched={ {k: c for k, c in counts.items() if c} } "
            f"max_abs_err={max(errs, default=None)} oracle_ok={ok}",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{name} SpMM: disagrees with the oracle")
        if not moved == predicted_mm == EXPECTED_MM[name]:
            raise AssertionError(
                f"{name} SpMM: launched {sorted(moved)}, predicted "
                f"{sorted(predicted_mm)}, expected "
                f"{sorted(EXPECTED_MM[name])} (no SpMV kernel, and in "
                "float64 no float32 kernel, may run)"
            )
        runs[name] = (A, x)
    # the bf16 main paths: the same entry points with values="bfloat16",
    # each SpMV and SpMM(8) apply held to the oracle at a 2-byte type's
    # gate and beside the float32 apply of the same matrix and x
    bruns = {}  # name -> (A, x, the float32 SparseMatrix beside it)
    for name, (f32run, reorder) in BF16_RUNS.items():
        csr, fmt, tuning, paired, rows_max = RUNS[name[:-5]]
        t0 = time.perf_counter()
        with _planning(paired, rows_max):
            A = SparseMatrix.create(csr, fmt)
            op = SpDMV(A, tuning, values="bfloat16", reorder=reorder)
            op_mm = SpDMM(A, tuning, values="bfloat16", reorder=reorder)
            t_tune = time.perf_counter() - t0
            if f32run is None:
                A32 = SparseMatrix.create(csr, fmt)
                SpDMV(A32, tuning, reorder=reorder)
            else:
                A32 = runs[f32run][0]
        if A.tuned.dtype != torch.float32:
            raise AssertionError(f"{name}: the tuned matrix is "
                                 f"{A.tuned.dtype}, not float32")
        predicted = {f"{k}_bf16" if k in BF16_KERNELS else k
                     for k in predict(A.tuned)}
        x = np.random.default_rng(1).uniform(1.0, 2.0, csr.ncols).astype(
            np.float32)
        xd = x.astype(np.float64)
        y, counts = counted(lambda: op(x))
        moved = {k for k, c in counts.items() if c}
        y_np = y.cpu().numpy()
        ok, err, serr = oracle_ok(y_np, csr, xd, A.tuned.nnz_full,
                                  np.float16)
        scale = oracle[id(csr), hashlib.sha1(xd).digest()][1]
        y32 = A32.tuned.matvec(torch.as_tensor(x, device=dev)).cpu().numpy()
        d32 = float((np.abs(y_np - y32) / np.maximum(scale, 1e-300)).max())
        print(
            f"main path {name}: n={csr.nrows} nnz_full={A.tuned.nnz_full} "
            f"{fmt.name}/{tuning.name} float32 x and y, bfloat16 values, "
            f"tune+upload {t_tune:.2f} s reorder={A.tuned.perm is not None} "
            f"stream_bytes bf16 {A.tuned.stream_bytes()} float32 "
            f"{A32.tuned.stream_bytes()} "
            f"({A.tuned.stream_bytes() / A32.tuned.stream_bytes():.3f}x) "
            f"predicted={sorted(predicted)} "
            f"launched={ {k: c for k, c in counts.items() if c} } "
            f"max_abs_err={err} max_scaled_err={serr} oracle_ok (2-byte "
            f"gate) {ok}; max scaled difference from the float32 apply "
            f"{d32}", flush=True)
        if not ok or y_np.dtype != np.float32:
            raise AssertionError(f"{name}: disagrees with the f64 oracle")
        if not moved == predicted == EXPECTED[name]:
            raise AssertionError(
                f"{name}: launched {sorted(moved)}, predicted "
                f"{sorted(predicted)}, expected {sorted(EXPECTED[name])} "
                "(a bf16 apply runs the bf16 instances, no float32 one)")
        X = np.random.default_rng(2).uniform(
            1.0, 2.0, (csr.ncols, RHS)).astype(np.float32)
        predicted_mm = {MM_OF[k] for k in predicted}
        Y, counts = counted(lambda: op_mm(X))
        moved = {k for k, c in counts.items() if c}
        Y_np = Y.cpu().numpy()
        Y32 = A32.tuned.matmat(torch.as_tensor(X, device=dev)).cpu().numpy()
        errs, d32s = [], []
        ok = Y_np.shape == (csr.nrows, RHS) and Y_np.dtype == np.float32
        for b in range(RHS if ok else 0):
            xb = X[:, b].astype(np.float64)
            ok_b, e_b, _ = oracle_ok(Y_np[:, b], csr, xb, A.tuned.nnz_full,
                                     np.float16)
            sc_b = oracle[id(csr), hashlib.sha1(xb).digest()][1]
            errs.append(e_b)
            d32s.append(float((np.abs(Y_np[:, b] - Y32[:, b])
                               / np.maximum(sc_b, 1e-300)).max()))
            ok = ok and ok_b
        print(
            f"main path {name} SpMM({RHS}): "
            f"predicted={sorted(predicted_mm)} "
            f"launched={ {k: c for k, c in counts.items() if c} } "
            f"max_abs_err={max(errs, default=None)} oracle_ok (2-byte gate) "
            f"{ok}; max scaled difference from the float32 apply "
            f"{max(d32s, default=None)}", flush=True)
        if not ok:
            raise AssertionError(f"{name} SpMM: disagrees with the oracle")
        if not moved == predicted_mm == EXPECTED_MM[name]:
            raise AssertionError(
                f"{name} SpMM: launched {sorted(moved)}, predicted "
                f"{sorted(predicted_mm)}, expected "
                f"{sorted(EXPECTED_MM[name])}")
        bruns[name] = (A, x, A32)
    print(f"launch counts of the main paths: {launches}", flush=True)
    # the double instances of the paired and signed diagonal kernels run on
    # the float64 distributed paths of phase 8, checked after it
    if not all(c for k, c in launches.items() if not k.endswith("_f64")):
        raise AssertionError("a kernel of the paths was never launched")
    # the plain ELL+COO float64 path, asked for by name: no kernel moves
    old_path, config.fp64_path = config.fp64_path, "xla"
    try:
        t_xla = tune(flag, fmt=Format.SSS, dtype=np.float64)
    finally:
        config.fp64_path = old_path
    _, x64 = runs["flagship_f64"]
    y, counts = counted(lambda: t_xla.matvec(torch.as_tensor(x64, device=dev)))
    ok, err, serr = oracle_ok(y.cpu().numpy(), flag, x64, t_xla.nnz_full,
                              np.float64)
    rem = t_xla.operands["row"]
    print(f"plain path CFS_FP64=xla on the flagship: ELL width "
          f"{t_xla.operands['ecol'].shape[1]}, remainder "
          f"{0 if rem is None else len(rem)}, max_abs_err={err} max_scaled_err={serr} oracle_ok={ok} "
          f"launched={ {k: c for k, c in counts.items() if c} }", flush=True)
    if not ok or any(counts.values()):
        raise AssertionError("the CFS_FP64=xla path disagrees with the "
                             "oracle or moved a kernel's count")
    phase_done("3 main paths")

    # -- 4. each kernel against its plain twin, on the real plan arrays --
    def operands(name):
        A, x = runs[name]
        _, d = A.tuned.pure_apply()
        xe = A.tuned.encode(torch.as_tensor(x, device=dev))
        return A, d, xe

    g = torch.Generator(device="cpu").manual_seed(7)
    kern = {}
    extra = {}  # further kernel rows (other plans), timed in phase 5

    def planes(B, rows, extra=0, dtype=torch.float32):
        """(B, rows, 128) random planes on the card; with ``extra``, a
        column slice of wider planes (plane stride past the plane)."""
        wide = torch.rand((B, rows + extra, 128), generator=g,
                          dtype=dtype).to(dev)
        return wide[:, :rows]

    def mm_pair(key, make, nnz_per_row, on, rows=None, exact=False,
                Bs=(11, RHS), flops=0):
        """Check the multi-RHS kernel ``key`` against its twin at each B
        of ``Bs`` (11 is two plane groups) and last at B = 8, whose
        closures are kept for the timing with ``flops`` operations.
        ``make(B)`` returns (check, fn, plain, scale, bytes, library):
        ``check()`` runs the kernel as the check wants it (NaN-poisoned
        output where it zeroes its own), ``scale()`` the twin on |.|,
        ``library()`` the one PyTorch call for the same function."""
        errs = []
        for B in Bs:
            check, fn, plain, scale, nbytes, library = make(B)
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
                         flops=flops, fn=fn, plain=plain, library=library)

    def poisoned(shape, dtype=torch.float32):
        return torch.full(shape, float("nan"), device=dev, dtype=dtype)

    def nnz_of(t):
        """Stored nonzeros of this run's value tensor."""
        return int(torch.count_nonzero(t))

    def csr_mv(S, x2d):
        """The library yardstick of a stream kernel: one sparse CSR
        product with the flat padded x, or with (x rows, B) for planes
        (the transposed copy is made once, outside the timed call)."""
        n = S.shape[1]  # a far stream may read fewer x rows than given
        if x2d.ndim == 2:
            xf = x2d.reshape(-1)[:n]
            return lambda: S @ xf
        Xf = x2d.reshape(x2d.shape[0], -1)[:, :n].T.contiguous()
        return lambda: S @ Xf

    mats = {"cant_proxy": cant, "audikw_proxy": audikw, "flagship": flag,
            "general_asym": gasym, "near_band_paired": nbp,
            "near_band_paired_400k": nbp400, "stencil27": st27}
    lib = {}

    def lib_operands(mname, dtype=torch.float32):
        """(M, x, X) of the library yardstick on a whole matrix: its
        sparse CSR tensor, a vector and ``RHS`` columns, built once per
        (matrix, dtype) for the kernel rows and the per-matrix lines."""
        if (mname, dtype) not in lib:
            csr = mats[mname]
            lib[mname, dtype] = (
                matrix_csr(torch, csr, dtype, dev),
                torch.rand(csr.ncols, generator=g, dtype=dtype).to(dev),
                torch.rand((csr.ncols, RHS), generator=g,
                           dtype=dtype).to(dev))
        return lib[mname, dtype]

    def strided(y3, launch):
        """``launch(y)`` on a copy of the planes ``y3`` held at a plane
        stride past the plane, NaN beyond each plane; raises when anything
        past a plane moved; returns the planes."""
        B, T = y3.shape[0], y3.shape[1]
        wide = poisoned((B, T + 3, 128), y3.dtype)
        wide[:, :T] = y3
        out = launch(wide[:, :T])
        torch.cuda.synchronize()
        if not torch.isnan(wide[:, T:]).all():
            raise AssertionError("a kernel wrote past a plane")
        return out

    def either_stage(wrapper, d, x_rows, T, on):
        """The symmetric diagonal kernel over planes with x staged and not
        (the plan takes ``d.dia_stage_x``) at B = 11, onto nonzero strided
        Y planes, against the twin."""
        dt, o = d.dia_vals.dtype, d.dia_offsets
        x3, y3 = planes(11, x_rows, dtype=dt), planes(11, T, extra=3,
                                                      dtype=dt)
        yp = sk.sdia_sym_tiles_mm_plain(d.dia_vals, x3, y3.clone(), o)
        ys = sk.sdia_sym_tiles_mm_plain(d.dia_vals.abs().double(),
                                        x3.abs().double(),
                                        y3.abs().double(), o)
        said = []
        for stage in (False, True):
            got = strided(y3, lambda y: wrapper(d.dia_vals, x3, y, o,
                                                stage_x=stage))
            what = f"{wrapper.__name__} stage_x={stage} B=11 on {on}"
            said.append(f"stage_x={stage} "
                        f"{_agree(got, yp, ys, 2 * len(o), what)}")
        print(f"kernel {wrapper.__name__} on {on} (the plan stages x: "
              f"{d.dia_stage_x}), B=11 either way: max_abs_err vs twin "
              + ", ".join(said), flush=True)

    # B1 + B11 on stencil27 (offsets past a value block) and on cant_proxy,
    # the kernel row's plan: B1 onto a nonzero incoming y, B11 onto nonzero
    # Y planes held at a plane stride past the plane, as the plan stages x
    # and both ways
    errs = []
    for run_name in ("stencil27", "cant_proxy"):
        A, d, xe = operands(run_name)
        x2d = ops.pad_x(xe, d.x_rows)
        y0 = torch.rand((d.num_row_tiles, 128), generator=g).to(dev)
        args = (d.dia_vals, x2d)
        yk = sk.sdia_sym_tiles(*args, y0.clone(), d.dia_offsets)
        yp = sk.sdia_sym_tiles_plain(*args, y0.clone(), d.dia_offsets)
        scale = sk.sdia_sym_tiles_plain(
            d.dia_vals.abs().double(), x2d.abs().double(), y0.abs().double(),
            d.dia_offsets,
        )
        errs.append(_agree(yk, yp, scale, 2 * d.dia_vals.shape[1],
                           f"sdia_sym on {run_name}"))
        print(f"kernel sdia_sym on {run_name}: offsets "
              f"{d.dia_offsets.tolist()}, max_abs_err vs twin {errs[-1]}",
              flush=True)
        M_cant, xl_cant, Xe_cant = lib_operands(run_name)

        def make_sdia_sym_mm(B, d=d, M=M_cant, Xe=Xe_cant):
            x3 = planes(B, d.x_rows)
            y3 = planes(B, d.num_row_tiles, extra=3)
            a = (d.dia_vals, x3)
            o, st = d.dia_offsets, d.dia_stage_x
            return (lambda: strided(y3, lambda y: sk.sdia_sym_tiles_mm(
                        *a, y, o, stage_x=st)),
                    lambda: sk.sdia_sym_tiles_mm(*a, y3.clone(), o,
                                                 stage_x=st),
                    lambda: sk.sdia_sym_tiles_mm_plain(*a, y3.clone(), o),
                    lambda: sk.sdia_sym_tiles_mm_plain(
                        d.dia_vals.abs().double(), x3.abs().double(),
                        y3.abs().double(), o),
                    _nbytes(d.dia_vals, x3) + 2 * _nbytes(y3),
                    lambda: M @ Xe)

        sym_flops = 4 * nnz_of(d.dia_vals)  # a row and a transpose product
        mm_pair("sdia_sym_mm", make_sdia_sym_mm, 2 * d.dia_vals.shape[1],
                run_name, flops=RHS * sym_flops)
        if run_name == "stencil27":
            extra["sdia_sym on stencil27"] = dict(
                err=errs[-1], on="stencil27",
                bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0),
                flops=sym_flops, library=lambda M=M_cant, v=xl_cant: M @ v,
                fn=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles(
                    *a, y.clone(), o),
                plain=lambda a=args, y=y0, o=d.dia_offsets:
                    sk.sdia_sym_tiles_plain(*a, y.clone(), o))
            extra["sdia_sym_mm on stencil27"] = dict(kern["sdia_sym_mm"])
        either_stage(sk.sdia_sym_tiles_mm, d, d.x_rows, d.num_row_tiles,
                     run_name)
    kern["sdia_sym"] = dict(
        err=max(errs), on="cant_proxy",
        bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0), flops=sym_flops,
        library=lambda: M_cant @ xl_cant,
        fn=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles(
            *a, y.clone(), o),
        plain=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles_plain(
            *a, y.clone(), o),
    )

    # B2 + B3 on audikw_proxy: the degree-grouped far stream, which visits
    # every output block (its planes are zeroed whole), B2 into a
    # NaN-poisoned buffer
    A, d, xe = operands("audikw_proxy")
    fd = d.far
    if not fd.covers:
        raise AssertionError("audikw_proxy's far stream should visit every "
                             "output block")
    x2d_a = ops.pad_x(xe, d.x_rows)
    kw_a = dict(fd.stream_kw(), covers=fd.covers)
    sargs_a = (fd.vals, fd.packed, fd.meta, fd.step_block, x2d_a)
    fk = bk.bell2_spmv_tiles(*sargs_a, out=poisoned(
        (-(-fd.num_row_tiles // fd.tiles_per_block) * fd.tiles_per_block,
         128)), **kw_a)
    if not torch.isfinite(fk).all():
        raise AssertionError("bell2_spmv on audikw_proxy: the covering "
                             "stream's output was not zeroed whole")
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
    S_far = stream_csr(torch, fd)
    kern["bell2_spmv"] = dict(
        err=err, on="audikw_proxy",
        bytes=_nbytes(*sargs_a) + _nbytes(fp), flops=2 * nnz_of(fd.vals),
        library=csr_mv(S_far, x2d_a),
        fn=lambda: bk.bell2_spmv_tiles(*sargs_a, **kw_a),
        plain=lambda: bk.bell2_spmv_tiles_plain(*sargs_a, **kw_a),
    )
    # B3 + B9 on audikw_proxy's grouped far stream (the main path's) and
    # on a degree-grouped replan over 8-tile blocks whose rows
    # 20,000-39,999 are absent (pk < 0): the gather, the seed form (D x
    # plus the gather, x read in place at its strides) and the into form
    # (the gather added into given tiles), SpMV and over B = 1, 2, 4, 8,
    # 11 planes, each bit-identical to its twin (the composed ops), out of
    # a NaN-poisoned allocation; absent rows must read exactly the seed, or
    # the tiles they were added into
    rng_u = np.random.default_rng(9)
    n_u = 90_000
    deg_u = np.zeros(n_u, np.int64)
    live_u = rng_u.choice(n_u, n_u // 2, replace=False)
    live_u = live_u[(live_u < 20_000) | (live_u >= 40_000)]
    deg_u[live_u] = rng_u.integers(1, 6, len(live_u))
    deg_u[live_u[:64]] = 300
    r_u = np.repeat(np.arange(n_u, dtype=np.int64), deg_u)
    holes_g = ops.to_device(build_bell2_plan(CSR.from_coo(COO(
        n_u, n_u, r_u, rng_u.integers(0, n_u, len(r_u)),
        rng_u.uniform(-1, 1, len(r_u)).astype(np.float32)).canonicalize()),
        tiles_per_block=8), dev)
    if not (holes_g.grouped and holes_g.tiles_per_block == 8
            and bool((holes_g.unperm_pk < 0).any())):
        raise AssertionError("the replan is not degree-grouped over 8-tile "
                             "blocks with absent rows")

    def poisoned_pool(fn, nbytes):
        """``fn()`` right after a NaN-filled block of ``nbytes`` is freed,
        which the caching allocator hands to the next allocation of its
        size: the output of a wrapper that allocates its own."""
        t = torch.full((nbytes // 4 + 1,), float("nan"), device=dev)
        del t
        return fn()

    def unperm_forms(gd, diag, NTu, on):
        """The three forms against their twins (see above); returns the
        worst |kernel - twin| (0: bit-identical, or it raised)."""
        a = (gd.unperm_pk, gd.unperm_slabs)
        n = diag.shape[0]
        pk = gd.unperm_pk.reshape(-1)
        absent = torch.nonzero(pk[:n] < 0).reshape(-1)
        for B in (None, 1, 2, 4, 8, 11):  # None: the SpMV wrapper
            Bp = B or 1
            g3 = planes(Bp, gd.num_row_tiles, extra=2)
            X = torch.rand((n, Bp + 3), generator=g).to(dev)[:, :Bp]
            into0 = planes(Bp, NTu, extra=1)
            if B is None:
                kfn, pfn, gt = (bk.unperm_gather_tiles,
                                bk.unperm_gather_tiles_plain, g3[0])
                sx, into_of = X[:, 0], (lambda: into0[0].clone())
            else:
                kfn, pfn, gt = (bk.unperm_gather_tiles_mm,
                                bk.unperm_gather_tiles_mm_plain, g3)
                sx, into_of = X, (lambda: into0.clone())
            for form in ("gather", "seed", "into"):
                def call(fn):
                    if form == "gather":
                        return fn(*a, gt)
                    if form == "seed":
                        return fn(*a, gt, seed=(diag, sx), tiles=NTu)
                    return fn(*a, gt, into=into_of())
                yk = poisoned_pool(lambda: call(kfn), 4 * Bp * NTu * 128)
                yp = call(pfn)
                torch.cuda.synchronize()
                what = f"unperm_gather {form} B={B or 'SpMV'} on {on}"
                if not (torch.equal(yk, yp) and torch.isfinite(yk).all()):
                    raise AssertionError(f"{what}: not bit-identical to its "
                                         "composed twin, or not finite")
                yk = yk.reshape(Bp, -1)
                if form == "seed":
                    want = (diag[:, None] * X).T[:, absent]
                elif form == "into":
                    want = into0.reshape(Bp, -1)[:, absent]
                else:
                    want = torch.zeros_like(yk[:, absent])
                if not torch.equal(yk[:, absent], want):
                    raise AssertionError(f"{what}: an absent row is not "
                                         "exactly its seed or its tiles")
        print(f"kernels unperm_gather / unperm_gather_mm on {on}: "
              f"{len(absent)} absent rows of {n}, gather, seed and into "
              f"forms, SpMV and B = 1, 2, 4, 8, 11, out of NaN-poisoned "
              f"allocations: bit-identical to the composed twins",
              flush=True)
        return 0.0

    unperm_forms(holes_g, torch.rand(n_u, generator=g).to(dev),
                 -(-n_u // 128) + 3, "a grouped replan over 8-tile blocks "
                 "with rows 20,000-39,999 absent")
    NT_a = d.num_row_tiles
    unperm_forms(fd, d.diag, NT_a, "audikw_proxy")
    # the kernel rows: the seed form, as audikw's applies run it; the
    # library call is the gather alone (index_select by the plan's
    # row_perm against the tiles with a zero appended), the nearest one
    # PyTorch call
    uargs = (fd.unperm_pk, fd.unperm_slabs, fp[: fd.num_row_tiles])
    useed = dict(seed=(d.diag, xe), tiles=NT_a)
    uk = bk.unperm_gather_tiles(*uargs, **useed)
    up = bk.unperm_gather_tiles_plain(*uargs, **useed)
    if not torch.equal(uk, up):
        raise AssertionError("unperm_gather: not bit-identical to its twin")
    perm_t = torch.as_tensor(np.asarray(A.tuned.plan.far.row_perm, np.int64),
                             device=dev)
    g_ext = torch.cat([uargs[2].reshape(-1), uargs[2].new_zeros(1)])
    live_g = int((fd.unperm_pk >= 0).sum())  # gathered values a plane
    kern["unperm_gather"] = dict(
        err=0.0, on="audikw_proxy (seed form)",
        bytes=_nbytes(fd.unperm_pk, d.diag, xe, uk) + 4 * live_g, flops=0,
        library=lambda: torch.index_select(g_ext, 0, perm_t),
        fn=lambda: bk.unperm_gather_tiles(*uargs, **useed),
        plain=lambda: bk.unperm_gather_tiles_plain(*uargs, **useed),
    )

    def make_unperm_mm(B, fd=fd):
        ua = (fd.unperm_pk, fd.unperm_slabs,
              planes(B, fd.num_row_tiles, extra=2))
        Xs = torch.rand((d.nrows, B), generator=g).to(dev)
        kw = dict(seed=(d.diag, Xs), tiles=NT_a)
        ext = torch.cat([ua[2].reshape(B, -1), ua[2].new_zeros((B, 1))], 1)
        return (lambda: bk.unperm_gather_tiles_mm(*ua, **kw),
                lambda: bk.unperm_gather_tiles_mm(*ua, **kw),
                lambda: bk.unperm_gather_tiles_mm_plain(*ua, **kw),
                None,
                _nbytes(fd.unperm_pk, d.diag, Xs) + 4 * B * (
                    live_g + NT_a * 128),
                lambda: torch.index_select(ext, 1, perm_t))

    mm_pair("unperm_gather_mm", make_unperm_mm, 0, "audikw_proxy (seed form)",
            exact=True)

    # B7 on an 8-tile-block replan of general_asym(g=50) whose rows
    # 20,000-59,999 are absent and get no covering chunks (so whole output
    # blocks are never visited, and they must keep their NaN), on
    # cant_proxy()'s untuned stream and on audikw_proxy's grouped far
    # stream (the kernel row's), each into NaN-poisoned planes and checked
    # on the visited blocks' rows; the covering two must come out finite
    # whole. B9 bit-identical
    coo = general_asym(g=50).to_coo()
    keep = (coo.row < 20_000) | (coo.row >= 60_000)
    hp_f = build_bell2_from_arrays(
        coo.nrows, coo.ncols, np.asarray(coo.row[keep], np.int32),
        np.asarray(coo.col[keep], np.int32),
        np.asarray(coo.val[keep], np.float32), dtype=np.float32,
        force_slot=True, tiles_per_block=8, cover_all_tiles=False)
    hp_f_contig = hp_f.windows_contig or hp_f.window_depth > 8
    ops._check_stream_plan(hp_f, hp_f_contig)
    holes_f = ops.Bell2Device(
        nrows=hp_f.nrows, ncols=hp_f.ncols, num_row_tiles=hp_f.num_row_tiles,
        x_rows=hp_f.x_rows, chunks_per_step=hp_f.chunks_per_step,
        tiles_per_block=hp_f.tiles_per_block, contig=hp_f_contig,
        sparse_stream=True, has_work=True,
        **{k: ops._tensor(getattr(hp_f, k), dev)
           for k in ("vals", "packed", "meta", "step_block")})
    _, d_none, _ = operands("cant_proxy_none")
    if not d_none.covers:
        raise AssertionError("cant_proxy's untuned stream should visit "
                             "every output block")

    def visited_rows(ds):
        """(rows of the visited blocks under num_row_tiles, mask of the
        padded planes' rows of unvisited blocks)."""
        BTs = ds.tiles_per_block
        TPs = -(-ds.num_row_tiles // BTs) * BTs
        visited = torch.unique(ds.step_block).long()
        rows_ = (visited[:, None] * BTs
                 + torch.arange(BTs, device=dev)[None, :]).reshape(-1)
        rest = torch.ones(TPs, dtype=torch.bool, device=dev)
        rest[rows_] = False
        return rows_[rows_ < ds.num_row_tiles], rest

    for ds, on in ((holes_f, "general_asym(g=50) with absent rows, 8-tile "
                    "blocks"),
                   (d_none, "cant_proxy NONE"), (fd, "audikw_proxy")):
        vrows, rest = visited_rows(ds)
        if ds is holes_f and not rest.any():
            raise AssertionError("the float replan has no unvisited block")
        TPs = rest.shape[0]
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        S_s = S_far if ds is fd else stream_csr(torch, ds)
        nnz_s = nnz_of(ds.vals)

        def make_bell2_mm(B, ds=ds, kw_s=kw_s, TPs=TPs, rest=rest, S_s=S_s,
                          on=on):
            sa = (ds.vals, ds.packed, ds.meta, ds.step_block,
                  planes(B, ds.x_rows, extra=2))
            # the kernel reads X interleaved, as the appliers pass it
            x_il = bk.interleave_x(sa[4].reshape(B, -1).T, ds.x_rows)
            il = (*sa[:4], x_il)

            def check():
                out = poisoned((B, TPs, 128))
                got = bk.bell2_spmm_tiles(*il, out=out, planes=B, **kw_s)
                torch.cuda.synchronize()
                if not torch.isnan(out[:, rest]).all():
                    raise AssertionError(f"bell2_spmm on {on}: an unvisited "
                                         "block was written")
                if ds.covers and not torch.isfinite(out).all():
                    raise AssertionError(f"bell2_spmm on {on}: the covering "
                                         "stream's planes were not zeroed "
                                         "whole")
                return got

            return (check,
                    lambda: bk.bell2_spmm_tiles(*il, planes=B, **kw_s),
                    lambda: bk.bell2_spmm_tiles_plain(*sa, **kw_s),
                    lambda: bk.bell2_spmm_tiles_plain(
                        ds.vals.abs(), *sa[1:4], sa[4].abs(), **kw_s),
                    _nbytes(*sa[:4]) + B * (_nbytes(sa[4][0])
                                            + 4 * ds.num_row_tiles * 128),
                    csr_mv(S_s, sa[4]))

        mm_pair("bell2_spmm", make_bell2_mm, nnz_s / ds.nrows, on,
                rows=vrows, flops=RHS * 2 * nnz_s)
        if ds is d_none:
            extra["bell2_spmm on cant_proxy NONE"] = dict(kern["bell2_spmm"])
        print(f"kernel bell2_spmm on {on}: {ds.meta.shape[0]} chunks, "
              f"window depth {'> 8 or contiguous' if ds.contig else 'listed'}"
              f", {len(torch.unique(ds.step_block))} of "
              f"{TPs // ds.tiles_per_block} blocks visited, covers="
              f"{ds.covers}", flush=True)

    # B4 + B8 on the flagship's sparse far residual, which travels as its
    # live entries: against the twin onto a nonzero y, and against the
    # chunk-grid twin on the host plan's padded arrays
    A, d, xe = operands("flagship")
    es = d.far.entries
    far_nnz_row = A.tuned.plan.far.nnz / A.nrows
    x2d_f = ops.pad_x(xe, d.x_rows)
    NT_f = d.num_row_tiles
    y0_f = torch.rand((NT_f, 128), generator=g).to(dev)
    es_abs = dataclasses.replace(es, vals=es.vals.abs().double())
    yk = bk.bell2_spmv_tiles_accum(es, x2d_f, y0_f.clone())
    yp = bk.bell2_spmv_tiles_accum_plain(es, x2d_f, y0_f.clone())
    ys = bk.bell2_spmv_tiles_accum_plain(es_abs, x2d_f.abs().double(),
                                         y0_f.abs().double())
    err = _agree(yk, yp, ys, far_nnz_row, "bell2_spmv_accum")
    grid_f = grid_on(torch, A.tuned.plan.far, dev)
    kw_g = dict(num_row_tiles=grid_f.num_row_tiles,
                chunks_per_step=grid_f.chunks_per_step,
                tiles_per_block=grid_f.tiles_per_block, contig=grid_f.contig)
    TPg = -(-grid_f.num_row_tiles // grid_f.tiles_per_block) \
        * grid_f.tiles_per_block
    yg = bk.bell2_spmv_tiles_plain(
        grid_f.vals, grid_f.packed, grid_f.meta, grid_f.step_block,
        x2d_f[: grid_f.x_rows], out=torch.zeros((TPg, 128), device=dev),
        **kw_g)
    Tg = min(NT_f, yg.shape[0])
    if yg[Tg:].abs().sum() != 0:
        raise AssertionError("the chunk grid names rows past the tiles")
    err_g = _agree(yk[:Tg], y0_f[:Tg] + yg[:Tg], ys[:Tg], far_nnz_row,
                   "bell2_spmv_accum against the chunk-grid twin")
    print(f"kernel bell2_spmv_accum on the flagship: {es.count} entries, "
          f"max_abs_err vs twin {err}, vs the chunk-grid twin "
          f"(bell2_spmv_tiles_plain on {grid_f.meta.shape[0]} chunks) "
          f"{err_g}", flush=True)
    S_res = stream_csr(torch, grid_f)  # its product, without the add into y
    del grid_f, yg  # 47 MB that the port itself never uploads
    touched_f = int(torch.unique(es.rows).numel())

    def entry_bytes(es, x, touched, B=1):
        """What the entry kernel must move: the entries (12 B each in
        float32, 16 in float64), x once, and the y rows the entries name
        read and written, per plane."""
        return (_nbytes(es.rows, es.cols, es.vals) + _nbytes(x)
                + 2 * es.vals.element_size() * touched * B)

    kern["bell2_spmv_accum"] = dict(
        err=max(err, err_g), on="flagship",
        bytes=entry_bytes(es, x2d_f, touched_f), flops=2 * es.count,
        library=csr_mv(S_res, x2d_f),
        fn=lambda: bk.bell2_spmv_tiles_accum(es, x2d_f, y0_f.clone()),
        plain=lambda: bk.bell2_spmv_tiles_accum_plain(
            es, x2d_f, y0_f.clone()),
    )

    # B4 rows on the same entries: y = D x + R x from x as it lies, its
    # rows off the pointers, every row written once (a NaN-poisoned buffer)
    rw_er = bk.entry_rows(es, d.nrows)
    rw_x, rw_d = xe.contiguous(), d.diag
    rw_buf = torch.full((d.nrows + 2 * rw_er.slices,), float("nan"),
                        device=dev)
    rw_y = bk.bell2_entries_rows(es, rw_er, rw_d, rw_x, out=rw_buf)
    rw_err = _agree(
        rw_y, bk.bell2_entries_rows_plain(es, rw_er, rw_d, rw_x),
        bk.bell2_entries_rows_plain(es_abs, rw_er, rw_d.abs().double(),
                                    rw_x.abs().double()),
        far_nnz_row + 1, "bell2_entries_rows")
    if not torch.equal(rw_y, bk.bell2_entries_rows(es, rw_er, rw_d, rw_x)):
        raise AssertionError("bell2_entries_rows does not repeat bit for bit")
    kern["bell2_entries_rows"] = dict(
        err=rw_err, on="flagship",
        bytes=_nbytes(rw_er.ptr, es.cols, es.vals, rw_d, rw_x)
        + 4 * d.nrows,
        flops=2 * (es.count + d.nrows),
        library=csr_mv(S_res, x2d_f),
        fn=lambda es=es, er=rw_er, dg=rw_d, x=rw_x: bk.bell2_entries_rows(
            es, er, dg, x),
        plain=lambda es=es, er=rw_er, dg=rw_d, x=rw_x:
            bk.bell2_entries_rows_plain(es, er, dg, x),
    )

    def make_bell2_acc_mm(B, es=es, es_abs=es_abs):
        x3 = planes(B, d.x_rows)
        y3 = planes(B, NT_f, extra=3)
        return (lambda: bk.bell2_spmm_tiles_accum(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(
                    es_abs, x3.abs().double(), y3.abs().double()),
                entry_bytes(es, x3, touched_f, B), csr_mv(S_res, x3))

    mm_pair("bell2_spmm_accum", make_bell2_acc_mm, far_nnz_row, "flagship",
            flops=RHS * 2 * es.count)

    # a hand-built accumulating stream over 8-tile blocks: rows
    # 8,192-24,575 absent, one row of 70 and one of 200 entries
    rng = np.random.default_rng(5)
    n_h = 40_960
    r_h = np.arange(n_h)
    r_h = r_h[(r_h < 8192) | (r_h >= 24_576)]
    c_h = rng.integers(0, n_h, len(r_h))
    r_h = np.concatenate([r_h, np.full(200, 30_000), np.full(70, 5)])
    c_h = np.concatenate([c_h, rng.choice(n_h, 200, replace=False),
                          rng.choice(n_h, 70, replace=False)])
    key = np.unique(r_h.astype(np.int64) * n_h + c_h)
    hp_acc = build_bell2_from_arrays(
        n_h, n_h, (key // n_h).astype(np.int32), (key % n_h).astype(np.int32),
        rng.uniform(-1, 1, len(key)).astype(np.float32), dtype=np.float32,
        tiles_per_block=8, cover_all_tiles=False)
    d_h = ops.to_device(hp_acc, dev)
    es_h = d_h.entries
    longest = int(torch.bincount(es_h.rows.long()).max())
    if d_h.vals is not None or es_h is None or longest < 64:
        raise AssertionError("the hand-built stream is not an entry list "
                             "with a row of 64 entries or more")

    # B4 and B8 on both entry lists at B = 1, 8 and 11, onto Y planes at a
    # plane stride past the plane; every row no entry names holds NaN and
    # must come back NaN bit for bit
    def poisoned_entries_check(es, x_rows, on, nnz_per_row):
        """Max abs error against the twin over B4 (B = 1) and B8 (B = 1,
        8, 11), or their float64 forms for a float64 entry list."""
        T = es.min_tiles
        dt = es.vals.dtype
        df = "_df" if dt == torch.float64 else ""
        mv_fn, mm_fn = ((bdf.bell2_spmv_tiles_accum_df,
                         bdf.bell2_spmm_tiles_accum_df) if df else
                        (bk.bell2_spmv_tiles_accum, bk.bell2_spmm_tiles_accum))
        bits = torch.int64 if df else torch.int32
        named = torch.zeros(T * 128, dtype=torch.bool, device=dev)
        named[es.rows.long()] = True
        es_abs = dataclasses.replace(es, vals=es.vals.abs().double())
        worst = 0.0
        for B, mv in ((1, True), (1, False), (RHS, False), (11, False)):
            x3 = planes(B, x_rows, dtype=dt)
            y0 = torch.rand((B, T * 128), generator=g, dtype=dt).to(dev)
            y0[:, ~named] = float("nan")
            wide = poisoned((B, T + 3, 128), dt)
            wide[:, :T] = y0.view(B, T, 128)
            y3 = wide[:, :T]
            if mv:
                mv_fn(es, x3[0], y3[0])
            else:
                mm_fn(es, x3, y3)
            torch.cuda.synchronize()
            yk = y3.reshape(B, -1)
            what = (f"{'bell2_spmv_accum' if mv else 'bell2_spmm_accum'}{df} "
                    f"B={B} on {on}")
            if not torch.equal(yk[:, ~named].view(bits),
                               y0[:, ~named].view(bits)):
                raise AssertionError(f"{what}: a row no entry names moved")
            if not torch.isnan(wide[:, T:]).all():
                raise AssertionError(f"{what}: wrote past a plane")
            y1 = torch.nan_to_num(y0, nan=0.0).view(B, T, 128)
            yp = bk.bell2_spmm_tiles_accum_plain(es, x3, y1.clone())
            ys = bk.bell2_spmm_tiles_accum_plain(
                es_abs, x3.abs().double(), y1.abs().double())
            sel = lambda t: t.reshape(B, -1)[:, named]  # noqa: E731
            worst = max(worst, _agree(sel(yk), sel(yp), sel(ys),
                                      nnz_per_row, what))
        return worst

    for es_c, xr, on, npr in (
            (es, d.x_rows, "the flagship", far_nnz_row),
            (es_h, d_h.x_rows, "the hand-built stream", hp_acc.nnz / n_h)):
        worst = poisoned_entries_check(es_c, xr, on, npr)
        for key_ in ("bell2_spmv_accum", "bell2_spmm_accum"):
            kern[key_]["err"] = max(kern[key_]["err"], worst)
        print(f"kernels bell2_spmv_accum / bell2_spmm_accum on {on}: "
              f"{es_c.count} entries in {es_c.min_tiles} tiles, longest row "
              f"{int(torch.bincount(es_c.rows.long()).max())}, B = 1, {RHS}, "
              f"11 onto strided NaN-poisoned planes: unnamed rows kept bit "
              f"for bit, max_abs_err vs twin {worst}", flush=True)

    # B5 on near_band_paired: the paired stream of the main path, the
    # same matrix planned with the other transpose-window count and with
    # 8-tile output blocks (the main plan has one block), and the
    # 400,000-row plan (several blocks, a stream past the L2), each into a
    # NaN-poisoned buffer
    A, d, xe = operands("near_band_paired")
    A4, d4, xe4 = operands("near_band_paired_400k")
    other_tw = 2 if d.transpose_windows == 4 else 4
    with _planning("force"):
        hp_bt8 = build_sbell_plan(A.csr,
                                  transpose_windows=d.transpose_windows,
                                  tiles_per_block=8)
        d_tw = ops.sym_to_device(
            build_sbell_plan(A.csr, transpose_windows=other_tw), dev)
    d_bt8 = ops.sym_to_device(hp_bt8, dev)

    def paired_geometry(dp):
        """(padded tiles of a plane, the wrappers' keywords)."""
        TP = -(-dp.num_row_tiles // dp.tiles_per_block) * dp.tiles_per_block
        return TP, dict(num_row_tiles=dp.num_row_tiles,
                        chunks_per_step=dp.chunks_per_step,
                        tiles_per_block=dp.tiles_per_block,
                        transpose_windows=dp.transpose_windows)

    def paired_stream(dp):
        return (dp.vals, dp.packed, dp.meta, dp.step_block)

    def walk(dp, planes_):
        """Chunks a CTA walks on ``dp``'s stream for a group of
        ``planes_`` planes, as the launcher chooses it."""
        return _cuda.lib().cfs_sbell_chunks_per_cta(
            dp.meta.shape[0], dp.transpose_windows, planes_,
            int(dp.vals.dtype == torch.float64))

    def paired_zero_check(dp, on):
        """The whole of every output plane is zeroed, and nothing past it
        is written: a zero x into NaN-poisoned planes at a plane stride
        past the plane, for one group of planes and for two."""
        TP, _ = paired_geometry(dp)
        dt = _cuda.xy_dtype(dp.vals)
        for B in (1, 11):
            x3 = torch.zeros((B, dp.x_rows, 128), device=dev, dtype=dt)
            wide = poisoned((B, TP + 3, 128), dt)
            bk._launch_sbell(*paired_stream(dp), x3, wide[:, :TP],
                             dp.chunks_per_step, dp.tiles_per_block,
                             dp.transpose_windows, "sbell zero check")
            torch.cuda.synchronize()
            if wide[:, :TP].ne(0).any():
                raise AssertionError(f"sbell_spmv on {on} B={B}: a covered "
                                     "output tile was not zeroed")
            if not torch.isnan(wide[:, TP:]).all():
                raise AssertionError(f"sbell_spmv on {on} B={B}: wrote past "
                                     "a plane")

    errs = []
    for dp, Ap, xp, on in (
            (d_tw, A, xe, "near_band_paired"),
            (d_bt8, A, xe, "near_band_paired"),
            (d4, A4, xe4, "near_band_paired_400k"),
            (d, A, xe, "near_band_paired")):  # the main plan's last
        TP, kw_p = paired_geometry(dp)
        pargs = (*paired_stream(dp), ops.pad_x(xp, dp.x_rows))
        yk = bk.sbell_spmv_tiles(*pargs, out=poisoned((TP, 128)), **kw_p)
        yp = bk.sbell_spmv_tiles_plain(*pargs, **kw_p)
        ys = bk.sbell_spmv_tiles_plain(
            dp.vals.abs(), *pargs[1:4], pargs[4].abs(), **kw_p)
        what = (f"sbell_spmv on {on} TW={dp.transpose_windows} "
                f"BT={dp.tiles_per_block}")
        errs.append(_agree(yk, yp, ys, 2 * Ap.tuned.nnz_full / Ap.nrows,
                           what))
        paired_zero_check(dp, on)
        print(f"kernel {what}: {dp.meta.shape[0]} chunks in "
              f"{TP // dp.tiles_per_block} blocks, {walk(dp, 1)} chunks a "
              f"CTA for one plane and {walk(dp, RHS)} for {RHS}, "
              f"max_abs_err vs twin {errs[-1]}; zero x into NaN-poisoned "
              f"strided planes (B = 1, 11): every covered tile zeroed, "
              f"nothing past a plane written", flush=True)
        if dp is d4:
            M_400, xl_400, Xe_400 = lib_operands("near_band_paired_400k")
            big = {"sbell_spmv": dict(
                err=errs[-1], on=f"{on} TW={dp.transpose_windows}",
                bytes=_nbytes(*pargs) + _nbytes(yp),
                flops=4 * nnz_of(dp.vals),
                library=lambda: M_400 @ xl_400,
                fn=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles(*a, **k),
                plain=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles_plain(
                    *a, **k))}
    if TP // d.tiles_per_block != 1 or len(torch.unique(d4.step_block)) < 2:
        raise AssertionError("the main paired plan should have one output "
                             "block and the 400,000-row plan several")
    # the paired stream is most of this matrix (the rest is its sparse
    # far stream and the main diagonal): the whole matrix's product is the
    # nearest library call
    M_nbp, xl_nbp, Xe_nbp = lib_operands("near_band_paired")
    kern["sbell_spmv"] = dict(
        err=max(errs), on=f"near_band_paired TW={d.transpose_windows}",
        bytes=_nbytes(*pargs) + _nbytes(yp), flops=4 * nnz_of(d.vals),
        library=lambda: M_nbp @ xl_nbp,
        fn=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles(*a, **k),
        plain=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles_plain(*a, **k),
    )
    # a plan that leaves an output block unvisited is refused at upload:
    # the 49-block replan without the steps of its middle block
    sb_h = np.asarray(hp_bt8.step_block)
    keep = sb_h != sb_h[len(sb_h) // 2]
    keep_c = np.repeat(keep, hp_bt8.chunks_per_step)
    holed = dataclasses.replace(
        hp_bt8, step_block=sb_h[keep], meta=hp_bt8.meta[keep_c],
        vals=hp_bt8.vals[np.repeat(keep_c, 8)],
        packed=hp_bt8.packed[np.repeat(keep_c, 8)])
    try:
        ops.sym_to_device(holed, dev)
    except ValueError as e:
        print(f"upload of a paired plan without block {sb_h[len(sb_h) // 2]} "
              f"of {len(np.unique(sb_h))}: refused ({e})", flush=True)
        if "every output block" not in str(e):
            raise
    else:
        raise AssertionError("sym_to_device took a paired plan that leaves "
                             "an output block unvisited")

    # B10 on the other transpose-window count and on the 8-tile-block
    # replan (49 blocks), both also at B = 2 (the two-plane instance; 11
    # is a group of 8 and one of 3, the four-plane instance), on the
    # 400,000-row plan, then on the main plan: x planes at a plane stride
    # past the plane, NaN-poisoned output planes
    for dp, Ap, on, M_X, Bs in (
            (d_tw, A, "near_band_paired", (M_nbp, Xe_nbp), (2, 11, RHS)),
            (d_bt8, A, "near_band_paired", (M_nbp, Xe_nbp), (2, 11, RHS)),
            (d4, A4, "near_band_paired_400k", (M_400, Xe_400), (11, RHS)),
            (d, A, "near_band_paired", (M_nbp, Xe_nbp), (11, RHS))):
        TPp, kw_q = paired_geometry(dp)

        def make_sbell_mm(B, dp=dp, TPp=TPp, kw_q=kw_q, M_X=M_X):
            sa = (*paired_stream(dp), planes(B, dp.x_rows, extra=2))
            return (lambda: bk.sbell_spmm_tiles(
                        *sa, out=poisoned((B, TPp, 128)), **kw_q),
                    lambda: bk.sbell_spmm_tiles(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(
                        dp.vals.abs(), *sa[1:4], sa[4].abs(), **kw_q),
                    _nbytes(*sa) + 4 * B * TPp * 128,
                    lambda: M_X[0] @ M_X[1])

        mm_pair("sbell_spmm", make_sbell_mm,
                2 * Ap.tuned.nnz_full / Ap.nrows,
                f"{on} TW={dp.transpose_windows} BT={dp.tiles_per_block} "
                f"({TPp // dp.tiles_per_block} blocks)", Bs=Bs,
                flops=RHS * 4 * nnz_of(dp.vals))
        if dp is d4:
            big["sbell_spmm"] = dict(kern["sbell_spmm"])

    # B6 + B12 on a ragged general_asym(g=50) plan (125,000 rows: fewer x
    # and y rows than its padded value blocks hold), on the flagship as a
    # general matrix (33 diagonals), on cant_proxy() mirrored (64) and on
    # general_asym's signed-offset peel (the kernel rows'): B6 onto a
    # nonzero y from padded x, and in the store form from x itself into a
    # NaN-poisoned y whose rows past the value blocks must read +0; B12 at
    # B = 1, 2, 4, 8, 11 from X in place where it is one interleaved group
    # (``sdia_kernel.gen_x``: B of 1, 2, 4, 8) and from ``interleave_x``'s
    # copy, adding onto nonzero Y planes and storing into NaN-poisoned
    # ones, each at a plane stride past the plane (nothing past a plane
    # may be written; the store form's rows past the value blocks +0)
    gen_plans = {"general_asym(g=50)": ops.to_device(
        build_general_plan(general_asym(g=50)), dev)}
    for run_name in ("flagship_csr", "cant_proxy_mirrored", "general_asym"):
        gen_plans[run_name] = operands(run_name)[1]

    def plus_zero_tail(y, nv, what):
        """The store form's rows past the nv value rows read +0."""
        tail = y.reshape(y.shape[0], -1)[:, nv:]
        if not ((tail == 0).all() and not torch.signbit(tail).any()):
            raise AssertionError(f"{what}: a row past the value blocks is "
                                 "not +0")

    gen_err = {"sdia_gen": 0.0, "sdia_gen_mm": 0.0}
    gen_ops = {}  # plan -> the operands of its kernel rows
    for on, dg in gen_plans.items():
        m = getattr(dg, "ncols", dg.nrows)
        vals, offs, T = dg.dia_vals, dg.dia_offsets, dg.num_row_tiles
        nv, D = vals.shape[0] * 1024, vals.shape[1]
        av = vals.abs().double()
        x = torch.rand(m, generator=g).to(dev)
        x2d = ops.pad_x(x, dg.x_rows)
        y0 = torch.rand((T, 128), generator=g).to(dev)
        yk = sk.sdia_gen_tiles(vals, x2d, y0.clone(), offs)
        yp = sk.sdia_gen_tiles_plain(vals, x2d, y0.clone(), offs)
        ys = sk.sdia_gen_tiles_plain(av, x2d.abs().double(),
                                     y0.abs().double(), offs)
        errs = [_agree(yk, yp, ys, D, f"sdia_gen add on {on}")]
        zk = sk.sdia_gen_tiles(vals, x, poisoned((T, 128)), offs, store=True)
        torch.cuda.synchronize()
        plus_zero_tail(zk[None], nv, f"sdia_gen store on {on}")
        zp = sk.sdia_gen_tiles_plain(vals, x, y0.clone(), offs, store=True)
        zs = sk.sdia_gen_tiles_plain(av, x.abs().double(), y0.clone().double(),
                                     offs, store=True)
        errs.append(_agree(zk, zp, zs, D, f"sdia_gen store on {on}"))
        gen_err["sdia_gen"] = max(gen_err["sdia_gen"], *errs)
        said = []
        for B in (1, 2, 4, 8, 11):
            X = torch.rand((m, B), generator=g).to(dev)
            x3 = ops.pad_x_mm(X, dg.x_rows)
            y3 = planes(B, T, extra=3)
            yp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs)
            ys = sk.sdia_gen_tiles_mm_plain(av, x3.abs().double(),
                                            y3.abs().double(), offs)
            zp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs,
                                            store=True)
            zs = sk.sdia_gen_tiles_mm_plain(av, x3.abs().double(),
                                            y3.abs().double(), offs,
                                            store=True)
            forms = {"copied": bk.interleave_x(X, dg.x_rows)}
            xg = sk.gen_x(X, dg.x_rows)
            if xg.data_ptr() == X.data_ptr():
                forms["in place"] = xg
            elif B in (1, 2, 4, 8):
                raise AssertionError(f"sdia_gen_mm on {on}: a contiguous "
                                     f"aligned X of B={B} was copied")
            worst = 0.0
            for xn, xil in forms.items():
                what = f"sdia_gen_mm B={B} X {xn} on {on}"
                add = strided(y3, lambda y: sk.sdia_gen_tiles_mm(
                    vals, xil, y, offs, planes=B))
                st = strided(poisoned((B, T, 128)), lambda y: (
                    sk.sdia_gen_tiles_mm(vals, xil, y, offs, planes=B,
                                         store=True)))
                plus_zero_tail(st, nv, what)
                worst = max(worst, _agree(add, yp, ys, D, f"{what} add"),
                            _agree(st, zp, zs, D, f"{what} store"))
            said.append(f"B={B} ({', '.join(forms)}) {worst}")
            gen_err["sdia_gen_mm"] = max(gen_err["sdia_gen_mm"], worst)
        print(f"kernels sdia_gen / sdia_gen_mm on {on}: {D} diagonals, "
              f"{nv} value rows, {T * 128} y rows, x {m}; "
              f"{sk.gen_slices(min(T * 128, nv), D, sk._thread_slots(dev))} "
              f"slices a row adding and "
              f"{sk.gen_slices(T * 128, D, sk._thread_slots(dev))} storing; "
              f"max_abs_err vs twin: B6 add {errs[0]}, store from x "
              f"{errs[1]}; B12 adding and storing, by X: " + "; ".join(said),
              flush=True)
        gen_ops[on] = (dg, x, x2d, y0, vals, offs, T, m)

    # the kernel rows: on general_asym the store forms its applies run (x
    # itself; X in place at B = 8); on the flagship as CSR and mirrored
    # cant the adding forms theirs run, onto nonzero y
    M_gasym, xl_gasym, Xe_gasym = lib_operands("general_asym")
    for on, mname in (("general_asym", "general_asym"),
                      ("flagship_csr", "flagship"),
                      ("cant_proxy_mirrored", "cant_proxy")):
        dg, x, x2d, y0, vals, offs, T, m = gen_ops[on]
        M_, xl_, Xe_ = lib_operands(mname)
        X8 = torch.rand((m, RHS), generator=g).to(dev)
        Y8 = torch.rand((RHS, T, 128), generator=g).to(dev)
        xg8 = sk.gen_x(X8, dg.x_rows)
        store = on == "general_asym"
        row = dict(
            err=gen_err["sdia_gen"], on=f"{on} ({'store' if store else 'add'})",
            flops=2 * nnz_of(vals), library=lambda M_=M_, xl_=xl_: M_ @ xl_)
        row_mm = dict(
            err=gen_err["sdia_gen_mm"],
            on=f"{on} ({'store' if store else 'add'}, X in place), B={RHS}",
            flops=RHS * 2 * nnz_of(vals),
            library=lambda M_=M_, Xe_=Xe_: M_ @ Xe_)
        if store:
            yo = torch.empty((T, 128), device=dev)
            row.update(
                bytes=_nbytes(vals, x, yo),
                fn=lambda a=(vals, x, yo, offs): sk.sdia_gen_tiles(
                    *a, store=True),
                plain=lambda a=(vals, x, yo, offs): sk.sdia_gen_tiles_plain(
                    *a, store=True))
            row_mm.update(
                bytes=_nbytes(vals, X8, Y8),
                fn=lambda a=(vals, xg8, Y8, offs): sk.sdia_gen_tiles_mm(
                    *a, planes=RHS, store=True),
                plain=lambda a=(vals, xg8, Y8, offs):
                    sk.sdia_gen_tiles_mm_plain(*a, planes=RHS, store=True))
        else:
            row.update(
                bytes=_nbytes(vals, x2d) + 2 * _nbytes(y0),
                fn=lambda a=(vals, x2d), y=y0, o=offs: sk.sdia_gen_tiles(
                    *a, y.clone(), o),
                plain=lambda a=(vals, x2d), y=y0, o=offs:
                    sk.sdia_gen_tiles_plain(*a, y.clone(), o))
            row_mm.update(
                bytes=_nbytes(vals, X8) + 2 * _nbytes(Y8),
                fn=lambda a=(vals, xg8), y=Y8, o=offs: sk.sdia_gen_tiles_mm(
                    *a, y.clone(), o, planes=RHS),
                plain=lambda a=(vals, xg8), y=Y8, o=offs:
                    sk.sdia_gen_tiles_mm_plain(*a, y.clone(), o, planes=RHS))
        if store:
            kern["sdia_gen"], kern["sdia_gen_mm"] = row, row_mm
        else:
            extra[f"sdia_gen on {on}"] = row
            extra[f"sdia_gen_mm on {on}"] = row_mm

    # B13 + B14 on stencil27's and cant_proxy's float64 plans (the kernel
    # row's): the diagonal stream with the halved main diagonal (offset
    # 0), onto nonzero y; B14 at B = 1, 11 and 8 onto Y planes at a plane
    # stride past the plane
    f64 = torch.float64
    errs = []
    for run_name in ("stencil27_f64", "cant_proxy_f64"):
        A, d, xe = operands(run_name)
        if 0 not in d.dia_offsets.tolist():
            raise AssertionError(f"{run_name} stores no main diagonal")
        TD = -(-d.nrows // 128)
        x2d = ops.pad_x(xe, max(d.x_rows, TD))
        y0 = torch.rand((TD, 128), generator=g, dtype=f64).to(dev)
        args = (d.dia_vals, x2d)
        yk = sdf.sdia_sym_tiles_df(*args, y0.clone(), d.dia_offsets)
        yp = sk.sdia_sym_tiles_plain(*args, y0.clone(), d.dia_offsets)
        scale = sk.sdia_sym_tiles_plain(d.dia_vals.abs(), x2d.abs(),
                                        y0.abs(), d.dia_offsets)
        errs.append(_agree(yk, yp, scale, 2 * d.dia_vals.shape[1],
                           f"sdia_sym_df on {run_name}"))
        print(f"kernel sdia_sym_df on {run_name}: offsets "
              f"{d.dia_offsets.tolist()}, max_abs_err vs twin {errs[-1]}",
              flush=True)
        M_cant64, xl_cant64, Xe_cant64 = lib_operands(run_name[:-4], f64)

        def make_sdia_df_mm(B, d=d, rows=x2d.shape[0], TD=TD, M=M_cant64,
                            Xe=Xe_cant64):
            x3 = planes(B, rows, extra=2, dtype=f64)
            y3 = planes(B, TD, extra=3, dtype=f64)
            a = (d.dia_vals, x3)
            o, st = d.dia_offsets, d.dia_stage_x
            return (lambda: strided(y3, lambda y: sdf.sdia_sym_tiles_df_mm(
                        *a, y, o, stage_x=st)),
                    lambda: sdf.sdia_sym_tiles_df_mm(*a, y3.clone(), o,
                                                     stage_x=st),
                    lambda: sk.sdia_sym_tiles_mm_plain(*a, y3.clone(), o),
                    lambda: sk.sdia_sym_tiles_mm_plain(
                        d.dia_vals.abs(), x3.abs(), y3.abs(), o),
                    _nbytes(d.dia_vals, x3) + 2 * _nbytes(y3),
                    lambda: M @ Xe)

        sym_flops = 4 * nnz_of(d.dia_vals)
        mm_pair("sdia_sym_df_mm", make_sdia_df_mm, 2 * d.dia_vals.shape[1],
                run_name.replace("_f64", " float64"), Bs=(1, 11, RHS),
                flops=RHS * sym_flops)
        if run_name == "stencil27_f64":
            extra["sdia_sym_df on stencil27 float64"] = dict(
                err=errs[-1], on="stencil27 float64",
                bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0),
                flops=sym_flops,
                library=lambda M=M_cant64, v=xl_cant64: M @ v,
                fn=lambda a=args, y=y0, o=d.dia_offsets:
                    sdf.sdia_sym_tiles_df(*a, y.clone(), o),
                plain=lambda a=args, y=y0, o=d.dia_offsets:
                    sk.sdia_sym_tiles_plain(*a, y.clone(), o))
            extra["sdia_sym_df_mm on stencil27 float64"] = dict(
                kern["sdia_sym_df_mm"])
        either_stage(sdf.sdia_sym_tiles_df_mm, d, x2d.shape[0], TD,
                     run_name)
    kern["sdia_sym_df"] = dict(
        err=max(errs), on="cant_proxy float64",
        bytes=_nbytes(d.dia_vals, x2d) + 2 * _nbytes(y0), flops=sym_flops,
        fn=lambda a=args, y=y0, o=d.dia_offsets: sdf.sdia_sym_tiles_df(
            *a, y.clone(), o),
        plain=lambda a=args, y=y0, o=d.dia_offsets: sk.sdia_sym_tiles_plain(
            *a, y.clone(), o),
        library=lambda: M_cant64 @ xl_cant64,
    )

    # B14 over a row-major X and Y (a diagonal-only float64 plan's SpMM)
    # on the same two plans: B of 2 to 16 (groups of 8 + 2 and 8 + 8, a
    # group of 6 in the instance of 8), each Y allocated where a NaN block
    # was freed, so a row left unwritten shows
    for run_name in ("stencil27_f64", "cant_proxy_f64"):
        A, d, _ = operands(run_name)
        M_r, _, _ = lib_operands(run_name[:-4], f64)

        def make_rows(B, d=d, M=M_r):
            X = torch.rand((d.nrows, B), generator=g, dtype=f64).to(dev)
            a = (d.dia_vals, X, d.dia_offsets)
            return (lambda: poisoned_pool(
                        lambda: sdf.sdia_sym_rows_df_mm(*a), X.numel() * 8),
                    lambda: sdf.sdia_sym_rows_df_mm(*a),
                    lambda: sdf.sdia_sym_rows_plain(*a),
                    lambda: sdf.sdia_sym_rows_plain(
                        d.dia_vals.abs(), X.abs(), d.dia_offsets),
                    _nbytes(d.dia_vals, X) + _nbytes(X),
                    lambda: M @ X)

        mm_pair("sdia_sym_rows_df_mm", make_rows, 2 * d.dia_vals.shape[1],
                run_name.replace("_f64", " float64, X and Y (n, B)"),
                Bs=(2, 4, 6, 10, 16, RHS),
                flops=RHS * 4 * nnz_of(d.dia_vals))

    # B15 + B16 on the chunk grid: first on an 8-tile-block replan of
    # general_asym(g=50) whose rows 20,000-59,999 are absent and get no
    # covering chunks (so whole output blocks are never visited), then on
    # general_asym's and audikw_proxy's float64 streams (the whole matrix,
    # audikw's expanded; both visit every block, so the kernel zeroes whole
    # planes); every output NaN-poisoned, compared on the visited blocks'
    # rows, and unvisited blocks must keep their NaN
    coo = general_asym(g=50).to_coo()
    keep = (coo.row < 20_000) | (coo.row >= 60_000)
    hp = build_bell2_from_arrays(
        coo.nrows, coo.ncols, np.asarray(coo.row[keep], np.int32),
        np.asarray(coo.col[keep], np.int32),
        np.asarray(coo.val[keep], np.float64), dtype=np.float64,
        force_slot=True, tiles_per_block=8, cover_all_tiles=False)
    # the upload takes this sparse plan as its entry list (checked below);
    # its chunk grid goes to the grid kernel's wrappers in a struct built
    # by hand after the same index checks
    d_hp = ops.fp64_to_device(hp, dev)
    if d_hp.entries is None or d_hp.vals is not None:
        raise AssertionError("fp64_to_device kept the chunk grid of a "
                             "sparse stream")
    hp_contig = hp.windows_contig or hp.window_depth > 8
    ops._check_stream_plan(hp, hp_contig)
    holes = ops.Fp64Device(
        nrows=hp.nrows, ncols=hp.ncols, num_row_tiles=hp.num_row_tiles,
        x_rows=hp.x_rows, chunks_per_step=hp.chunks_per_step,
        tiles_per_block=hp.tiles_per_block, contig=hp_contig, has_work=True,
        **{k: ops._tensor(getattr(hp, k), dev)
           for k in ("vals", "packed", "meta", "step_block")})
    _, d_ga, xe_ga = operands("general_asym_f64")
    A, d, xe = operands("audikw_proxy_f64")
    if not (d_ga.covers and d.covers):
        raise AssertionError("the general_asym and audikw float64 streams "
                             "should visit every output block")
    x_h = torch.rand(holes.ncols, generator=g, dtype=f64).to(dev)
    dense = {}  # the grid kernels on general_asym float64, timed in phase 5
    for ds, xs_, on in ((holes, x_h, "general_asym(g=50) with absent rows, "
                         "8-tile blocks"),
                        (d_ga, xe_ga, "general_asym float64"),
                        (d, xe, "audikw_proxy float64")):
        BTs = ds.tiles_per_block
        TPs = -(-ds.num_row_tiles // BTs) * BTs
        visited = torch.unique(ds.step_block).long()
        rows = (visited[:, None] * BTs
                + torch.arange(BTs, device=dev)[None, :]).reshape(-1)
        rest = torch.ones(TPs, dtype=torch.bool, device=dev)
        rest[rows] = False
        rows = rows[rows < ds.num_row_tiles]
        if ds is holes and not (rest.any() and len(visited) > 8):
            raise AssertionError("the replan has no unvisited block")
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        x2d_s = ops.pad_x(xs_, ds.x_rows)
        sargs = (ds.vals, ds.packed, ds.meta, ds.step_block, x2d_s)
        out = poisoned((TPs, 128), f64)
        fk = bdf.bell2_spmv_tiles_df(*sargs, out=out, **kw_s)
        fp = bk.bell2_spmv_tiles_plain(*sargs, **kw_s)
        fs = bk.bell2_spmv_tiles_plain(ds.vals.abs(), *sargs[1:4],
                                       x2d_s.abs(), **kw_s)
        nnz_s = nnz_of(ds.vals)
        err = _agree(fk[rows], fp[rows], fs[rows], nnz_s / ds.nrows,
                     f"bell2_spmv_df on {on}")
        if not torch.isnan(out[rest]).all():
            raise AssertionError(f"bell2_spmv_df on {on}: an unvisited "
                                 "block was written")
        if ds.covers and not torch.isfinite(out).all():
            raise AssertionError(f"bell2_spmv_df on {on}: the covering "
                                 "stream's planes were not zeroed whole")
        print(f"kernel bell2_spmv_df on {on}: {ds.meta.shape[0]} chunks, "
              f"{len(visited)} of {TPs // BTs} blocks visited, contig="
              f"{ds.contig}, covers={ds.covers}, max_abs_err vs twin {err}",
              flush=True)
        S_df = stream_csr(torch, ds)
        kern["bell2_spmv_df"] = dict(
            err=max(err, kern.get("bell2_spmv_df", {}).get("err", 0.0)),
            on=on, bytes=_nbytes(*sargs) + _nbytes(fp), flops=2 * nnz_s,
            fn=lambda sargs=sargs, kw_s=kw_s: bdf.bell2_spmv_tiles_df(
                *sargs, **kw_s),
            plain=lambda sargs=sargs, kw_s=kw_s: bk.bell2_spmv_tiles_plain(
                *sargs, **kw_s),
            library=csr_mv(S_df, x2d_s),
        )

        def make_bell2_df_mm(B, ds=ds, TPs=TPs, kw_s=kw_s, rest=rest,
                             S_df=S_df, on=on, fp=fp):
            sa = (ds.vals, ds.packed, ds.meta, ds.step_block,
                  planes(B, ds.x_rows, extra=2, dtype=f64))

            def check():
                out = poisoned((B, TPs, 128), f64)
                got = bdf.bell2_spmm_tiles_df(*sa, out=out, **kw_s)
                if not torch.isnan(out[:, rest]).all():
                    raise AssertionError(f"bell2_spmm_df on {on}: an "
                                         "unvisited block was written")
                return got

            return (check,
                    lambda: bdf.bell2_spmm_tiles_df(*sa, **kw_s),
                    lambda: bk.bell2_spmm_tiles_plain(*sa, **kw_s),
                    lambda: bk.bell2_spmm_tiles_plain(
                        ds.vals.abs(), *sa[1:4], sa[4].abs(), **kw_s),
                    _nbytes(*sa[:4]) + B * (_nbytes(sa[4][0]) + _nbytes(fp)),
                    csr_mv(S_df, sa[4]))

        mm_pair("bell2_spmm_df", make_bell2_df_mm, nnz_s / ds.nrows, on,
                rows=rows, Bs=(1, 11, RHS), flops=RHS * 2 * nnz_s)
        if ds is d_ga:
            dense = {k: dict(kern[k])
                     for k in ("bell2_spmv_df", "bell2_spmm_df")}

    # B15 + B16 on entries: the float64 flagship's peel residual and the
    # g=50 replan's entry list (absent rows, unvisited blocks), each onto a
    # nonzero y against the twin and against the chunk-grid twin of the
    # same plan (every block zeroed, then added to the seed), then at B =
    # 1, 8 and 11 onto strided NaN-poisoned planes seeded finite on the
    # named rows
    A_r, d_r, xe_r = operands("flagship_f64")
    es_r = d_r.entries
    grid_r = grid_on(torch, A_r.tuned.plan, dev)

    def entries_vs_grid(es, gd, xs_, nrows, npr, on):
        """(max abs error against the twin and against the chunk-grid
        twin, x2d, y0) of the double entry kernel onto a nonzero y."""
        TDe = -(-nrows // 128)
        x2d_e = ops.pad_x(xs_, max(gd.x_rows, TDe))
        y0 = torch.rand((TDe, 128), generator=g, dtype=f64).to(dev)
        es_abs = dataclasses.replace(es, vals=es.vals.abs())
        yk = bdf.bell2_spmv_tiles_accum_df(es, x2d_e, y0.clone())
        yp = bk.bell2_spmv_tiles_accum_plain(es, x2d_e, y0.clone())
        ys = bk.bell2_spmv_tiles_accum_plain(es_abs, x2d_e.abs(), y0.abs())
        err = _agree(yk, yp, ys, npr, f"bell2_spmv_accum_df on {on}")
        BTg = gd.tiles_per_block
        TPg = -(-gd.num_row_tiles // BTg) * BTg
        yg = bk.bell2_spmv_tiles_plain(
            gd.vals, gd.packed, gd.meta, gd.step_block, x2d_e[: gd.x_rows],
            out=torch.zeros((TPg, 128), dtype=f64, device=dev),
            num_row_tiles=gd.num_row_tiles, chunks_per_step=gd.chunks_per_step,
            tiles_per_block=BTg, contig=gd.contig)
        Tg = min(TDe, yg.shape[0])
        if yg[Tg:].abs().sum() != 0:
            raise AssertionError(f"{on}: the chunk grid names rows past "
                                 "the result")
        err_g = _agree(yk[:Tg], y0[:Tg] + yg[:Tg], ys[:Tg], npr,
                       f"bell2_spmv_accum_df on {on} against the chunk-grid "
                       "twin")
        print(f"kernel bell2_spmv_accum_df on {on}: {es.count} entries "
              f"({_nbytes(es.rows, es.cols, es.vals) / 1e6:.3f} MB) in place "
              f"of {gd.meta.shape[0]} chunks ({_nbytes(gd.vals, gd.packed) / 1e6:.2f} MB), "
              f"max_abs_err vs twin {err}, vs the chunk-grid twin {err_g}",
              flush=True)
        return max(err, err_g), x2d_e, y0

    res_npr = A_r.tuned.plan.nnz / A_r.nrows
    err_r, x2d_r, y0_r = entries_vs_grid(
        es_r, grid_r, xe_r, A_r.nrows, res_npr, "the float64 flagship's residual")
    err_h, _, _ = entries_vs_grid(
        d_hp.entries, holes, x_h, hp.nrows, hp.nnz / hp.nrows,
        "general_asym(g=50) with absent rows")
    S_res64 = stream_csr(torch, grid_r)  # the residual's live entries
    del grid_r  # 79 MB that the port itself never uploads
    touched_r = int(torch.unique(es_r.rows).numel())
    kern["bell2_spmv_accum_df"] = dict(
        err=max(err_r, err_h), on="flagship float64 residual",
        bytes=entry_bytes(es_r, x2d_r, touched_r), flops=2 * es_r.count,
        library=csr_mv(S_res64, x2d_r),
        fn=lambda: bdf.bell2_spmv_tiles_accum_df(es_r, x2d_r, y0_r.clone()),
        plain=lambda: bk.bell2_spmv_tiles_accum_plain(es_r, x2d_r,
                                                      y0_r.clone()),
    )

    def make_acc_df_mm(B):
        x3 = planes(B, x2d_r.shape[0], dtype=f64)
        y3 = planes(B, y0_r.shape[0], extra=3, dtype=f64)
        es_abs = dataclasses.replace(es_r, vals=es_r.vals.abs())
        return (lambda: bdf.bell2_spmm_tiles_accum_df(es_r, x3, y3.clone()),
                lambda: bdf.bell2_spmm_tiles_accum_df(es_r, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(es_r, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(
                    es_abs, x3.abs(), y3.abs()),
                entry_bytes(es_r, x3, touched_r, B), csr_mv(S_res64, x3))

    mm_pair("bell2_spmm_accum_df", make_acc_df_mm, res_npr,
            "flagship float64 residual", flops=RHS * 2 * es_r.count)
    for es_c, xr, on, npr in (
            (es_r, x2d_r.shape[0], "the float64 flagship's residual",
             res_npr),
            (d_hp.entries, max(hp.x_rows, -(-hp.nrows // 128)),
             "general_asym(g=50) with absent rows", hp.nnz / hp.nrows)):
        worst = poisoned_entries_check(es_c, xr, on, npr)
        for key_ in ("bell2_spmv_accum_df", "bell2_spmm_accum_df"):
            kern[key_]["err"] = max(kern[key_]["err"], worst)
        print(f"kernels bell2_spmv_accum_df / bell2_spmm_accum_df on {on}: "
              f"{es_c.count} entries in {es_c.min_tiles} tiles, B = 1, "
              f"{RHS}, 11 onto strided NaN-poisoned planes: unnamed rows "
              f"kept bit for bit, max_abs_err vs twin {worst}", flush=True)

    # B2 as it ships, in float32 and bf16 (the values cast on the card), on
    # audikw_proxy's far stream, cant_proxy NONE, shard 1 of D3's far grids
    # (general_asym() over 4 shards; phase 8 applies this operator) and the
    # float replan with absent rows: into NaN-poisoned tiles a few rows past
    # the output after either zero pass, nothing written past the tiles,
    # unvisited blocks keep their NaN, a covering stream's tiles come out
    # finite whole, and the visited rows agree with the twin; whether it
    # gives the same bits in 4 calls; and one SpMV kernel row each for
    # cant_proxy NONE and the shard, in both types, timed in phase 5
    from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
    from cfs_spmv_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    d3_op = DistSpDMV(gasym, make_mesh(4, device="cuda:0"))
    d3_far = d3_op.shards[1].far
    print(f"the float32 operator of D3 (general_asym, P = 4) planned and "
          f"uploaded in {time.perf_counter() - t0:.2f} s", flush=True)
    b2_streams = {
        "audikw_proxy": fd, "cant_proxy NONE": d_none,
        "D3 general_asym P=4 shard 1": d3_far,
        "general_asym(g=50) with absent rows, 8-tile blocks": holes_f}

    def b2_row(sa, ds, on):
        """The kernel row of B2 (float32 or bf16 values ``sa[0]``) on a
        stream: checked against its twin on the visited rows."""
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        vrows, _ = visited_rows(ds)
        S_s = stream_csr(torch, dataclasses.replace(ds, vals=sa[0].float()))
        yp = bk.bell2_spmv_tiles_plain(*sa, **kw_s)
        ys = bk.bell2_spmv_tiles_plain(sa[0].abs(), *sa[1:4], sa[4].abs(),
                                       **kw_s)
        nnz_s = nnz_of(sa[0])
        err = _agree(bk.bell2_spmv_tiles(*sa, **kw_s)[vrows], yp[vrows],
                     ys[vrows], nnz_s / ds.nrows, f"bell2_spmv on {on}")
        return dict(err=err, on=on, bytes=_nbytes(*sa) + _nbytes(yp),
                    flops=2 * nnz_s, library=csr_mv(S_s, sa[4]),
                    fn=lambda: bk.bell2_spmv_tiles(*sa, **kw_s),
                    plain=lambda: bk.bell2_spmv_tiles_plain(*sa, **kw_s))

    for on, ds in b2_streams.items():
        vrows, rest = visited_rows(ds)
        TPs = rest.shape[0]
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        x2 = planes(1, ds.x_rows)[0]
        for vt in (torch.float32, torch.bfloat16):
            sa = (ds.vals.to(vt), ds.packed, ds.meta, ds.step_block, x2)
            tname = "bf16" if vt == torch.bfloat16 else "float32"
            yp = bk.bell2_spmv_tiles_plain(*sa, **kw_s)
            ysc = bk.bell2_spmv_tiles_plain(sa[0].abs(), *sa[1:4], x2.abs(),
                                            **kw_s)
            npr = nnz_of(sa[0]) / ds.nrows
            worst = 0.0
            for tiles in ((0, TPs) if ds.covers else (0,)):
                wide = poisoned((TPs + 3, 128))
                bk.bell2_spmv_tiles(*sa, out=wide[:TPs],
                                    **dict(kw_s, covers=bool(tiles)))
                torch.cuda.synchronize()
                what = (f"bell2_spmv {tname} zero="
                        f"{'memset' if tiles else 'kernel'} on {on}")
                if not torch.isnan(wide[TPs:]).all():
                    raise AssertionError(f"{what}: wrote past the tiles")
                if not torch.isnan(wide[:TPs][rest]).all():
                    raise AssertionError(f"{what}: an unvisited block "
                                         "was written")
                if tiles and not torch.isfinite(wide[:TPs]).all():
                    raise AssertionError(f"{what}: tiles not zeroed whole")
                worst = max(worst, _agree(wide[vrows], yp[vrows],
                                          ysc[vrows], npr, what))
            reps = [bk.bell2_spmv_tiles(*sa, **kw_s).clone()
                    for _ in range(4)]
            same = all(torch.equal(reps[0], r) for r in reps[1:])
            zeros = "either zero pass" if ds.covers else "the zero kernel"
            print(f"kernel bell2_spmv (B2) {tname} on {on} "
                  f"({ds.meta.shape[0]} chunks, contig={ds.contig}, "
                  f"covers={ds.covers}): after {zeros} into NaN-poisoned "
                  f"tiles, max_abs_err vs twin {worst}; the same bits in 4 "
                  f"calls: {same} ({card})", flush=True)
            if on in ("cant_proxy NONE", "D3 general_asym P=4 shard 1"):
                key = "bell2_spmv_bf16" if vt == torch.bfloat16 else \
                    "bell2_spmv"
                extra[f"{key} on {on}"] = b2_row(sa, ds, on)
    # -- 4b. the bf16 instances against their twins, on the bf16 runs' plan
    # arrays and on replans over 8-tile blocks with absent rows, at B = 11
    # and 8 over planes, into NaN-poisoned outputs where a kernel writes
    # its own; each twin computes on the values widened to float32
    def bf_operands(name):
        A_, x_, _ = bruns[name]
        _, d_ = A_.tuned.pure_apply()
        return A_, d_, A_.tuned.encode(torch.as_tensor(x_, device=dev))

    def lib_bf16(mname):
        """The library yardstick of a bf16 row: the whole matrix's CSR
        product with its values rounded to bfloat16 and stored in float32
        (PyTorch multiplies no bf16 values by a float32 x), on the float32
        rows' x and X."""
        if (mname, "bf16") not in lib:
            M_, xv_, Xv_ = lib_operands(mname)
            lib[mname, "bf16"] = (torch.sparse_csr_tensor(
                M_.crow_indices(), M_.col_indices(),
                M_.values().to(torch.bfloat16).float(), M_.shape), xv_, Xv_)
        return lib[mname, "bf16"]

    def is_bf16(*ts):
        if any(t.dtype != torch.bfloat16 for t in ts):
            raise AssertionError("a bf16 plan uploaded values in "
                                 f"{[t.dtype for t in ts]}")

    # B1 + B11 on stencil27 and cant_proxy (the kernel row's)
    errs = []
    for run_name, mname in (("stencil27_bf16", "stencil27"),
                            ("cant_proxy_bf16", "cant_proxy")):
        A, d, xe = bf_operands(run_name)
        dv, o = d.dia_vals, d.dia_offsets
        is_bf16(dv)
        x2d = ops.pad_x(xe, d.x_rows)
        y0 = torch.rand((d.num_row_tiles, 128), generator=g).to(dev)
        yk = sk.sdia_sym_tiles(dv, x2d, y0.clone(), o)
        yp = sk.sdia_sym_tiles_plain(dv, x2d, y0.clone(), o)
        ys = sk.sdia_sym_tiles_plain(dv.abs().double(), x2d.abs().double(),
                                     y0.abs().double(), o)
        errs.append(_agree(yk, yp, ys, 2 * dv.shape[1],
                           f"sdia_sym bf16 on {run_name}"))
        M_b, xl_b, Xe_b = lib_bf16(mname)

        def make_sym_bf16(B, d=d, M=M_b, Xe=Xe_b):
            x3 = planes(B, d.x_rows)
            y3 = planes(B, d.num_row_tiles, extra=3)
            a = (d.dia_vals, x3)
            o, st = d.dia_offsets, d.dia_stage_x
            return (lambda: strided(y3, lambda y: sk.sdia_sym_tiles_mm(
                        *a, y, o, stage_x=st)),
                    lambda: sk.sdia_sym_tiles_mm(*a, y3.clone(), o,
                                                 stage_x=st),
                    lambda: sk.sdia_sym_tiles_mm_plain(*a, y3.clone(), o),
                    lambda: sk.sdia_sym_tiles_mm_plain(
                        d.dia_vals.abs().double(), x3.abs().double(),
                        y3.abs().double(), o),
                    _nbytes(d.dia_vals, x3) + 2 * _nbytes(y3),
                    lambda: M @ Xe)

        sym_flops = 4 * nnz_of(dv)
        mm_pair("sdia_sym_mm_bf16", make_sym_bf16, 2 * dv.shape[1],
                f"{run_name}", flops=RHS * sym_flops)
        # x staged and not, whatever the plan says
        x3 = planes(11, d.x_rows)
        y3 = planes(11, d.num_row_tiles, extra=3)
        yp3 = sk.sdia_sym_tiles_mm_plain(dv, x3, y3.clone(), o)
        ys3 = sk.sdia_sym_tiles_mm_plain(dv.abs().double(), x3.abs().double(),
                                         y3.abs().double(), o)
        said = [f"stage_x={st} " + str(_agree(
            strided(y3, lambda y: sk.sdia_sym_tiles_mm(dv, x3, y, o,
                                                       stage_x=st)),
            yp3, ys3, 2 * dv.shape[1], f"sdia_sym_mm bf16 stage_x={st}"))
            for st in (False, True)]
        print(f"kernel sdia_sym bf16 on {run_name}: max_abs_err vs twin "
              f"{errs[-1]}; sdia_sym_mm bf16 B=11 either way: "
              + ", ".join(said), flush=True)
    kern["sdia_sym_bf16"] = dict(
        err=max(errs), on="cant_proxy bf16",
        bytes=_nbytes(dv, x2d) + 2 * _nbytes(y0), flops=sym_flops,
        library=lambda M=M_b, v=xl_b: M @ v,
        fn=lambda a=(dv, x2d), y=y0, o=o: sk.sdia_sym_tiles(*a, y.clone(),
                                                            o),
        plain=lambda a=(dv, x2d), y=y0, o=o: sk.sdia_sym_tiles_plain(
            *a, y.clone(), o))

    # B2 + B7 on audikw_proxy's far stream without reordering (the kernel
    # rows') and on the 8-tile-block replan of general_asym(g=50) with
    # absent rows and unvisited blocks, cast to bf16
    A, d, xe = bf_operands("audikw_proxy_bf16")
    holes_b = dataclasses.replace(holes_f,
                                  vals=holes_f.vals.to(torch.bfloat16))
    for ds, on in ((holes_b, "general_asym(g=50) with absent rows, 8-tile "
                    "blocks, bf16"), (d.far, "audikw_proxy bf16")):
        is_bf16(ds.vals)
        vrows, rest = visited_rows(ds)
        TPs = rest.shape[0]
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        x2 = (ops.pad_x(xe, ds.x_rows) if ds is d.far
              else planes(1, ds.x_rows)[0])
        sa = (ds.vals, ds.packed, ds.meta, ds.step_block, x2)
        out = poisoned((TPs, 128))
        yk = bk.bell2_spmv_tiles(*sa, out=out, **kw_s)
        torch.cuda.synchronize()
        if not torch.isnan(out[rest]).all() or (
                ds.covers and not torch.isfinite(out).all()):
            raise AssertionError(f"bell2_spmv bf16 on {on}: an unvisited "
                                 "block written, or a covering stream's "
                                 "output not zeroed whole")
        yp = bk.bell2_spmv_tiles_plain(*sa, **kw_s)
        ys = bk.bell2_spmv_tiles_plain(ds.vals.abs(), *sa[1:4], x2.abs(),
                                       **kw_s)
        nnz_s = nnz_of(ds.vals)
        err = _agree(yk[vrows], yp[vrows], ys[vrows], nnz_s / ds.nrows,
                     f"bell2_spmv bf16 on {on}")
        S_s = stream_csr(torch, dataclasses.replace(ds, vals=ds.vals.float()))
        mm_pair("bell2_spmm_bf16", lambda B, ds=ds, kw_s=kw_s, TPs=TPs,
                rest=rest, S_s=S_s, on=on: make_bell2_mm(
                    B, ds=ds, kw_s=kw_s, TPs=TPs, rest=rest, S_s=S_s, on=on),
                nnz_s / ds.nrows, on, rows=vrows, flops=RHS * 2 * nnz_s)
        print(f"kernel bell2_spmv bf16 on {on}: {ds.meta.shape[0]} chunks, "
              f"{len(torch.unique(ds.step_block))} of "
              f"{TPs // ds.tiles_per_block} blocks visited, covers="
              f"{ds.covers}, max_abs_err vs twin {err}", flush=True)
        errs = [err] if ds is holes_b else errs + [err]
    kern["bell2_spmv_bf16"] = dict(
        err=max(errs), on="audikw_proxy bf16 (no reordering)",
        bytes=_nbytes(*sa) + _nbytes(yp), flops=2 * nnz_s,
        library=csr_mv(S_s, x2),
        fn=lambda a=sa, k=kw_s: bk.bell2_spmv_tiles(*a, **k),
        plain=lambda a=sa, k=kw_s: bk.bell2_spmv_tiles_plain(*a, **k))

    def grid_rows(ds, on, x2):
        """(SpMV row, SpMM(8) row) of a one-sided grid stream, each
        checked against its twin on the visited blocks' rows."""
        kw_s = dict(ds.stream_kw(), covers=ds.covers)
        sa = (ds.vals, ds.packed, ds.meta, ds.step_block, x2)
        vrows, rest = visited_rows(ds)
        S_s = stream_csr(torch, dataclasses.replace(ds, vals=ds.vals.float()))
        nnz_s = nnz_of(ds.vals)
        yp = bk.bell2_spmv_tiles_plain(*sa, **kw_s)
        ys = bk.bell2_spmv_tiles_plain(ds.vals.abs(), *sa[1:4], x2.abs(),
                                       **kw_s)
        err = _agree(bk.bell2_spmv_tiles(*sa, **kw_s)[vrows], yp[vrows],
                     ys[vrows], nnz_s / ds.nrows, f"bell2_spmv on {on}")
        check, fn, plain, scale, nbytes, library = make_bell2_mm(
            RHS, ds=ds, kw_s=kw_s, TPs=rest.shape[0], rest=rest, S_s=S_s,
            on=on)
        err_mm = _agree(check()[:, vrows], plain()[:, vrows],
                        scale()[:, vrows], nnz_s / ds.nrows,
                        f"bell2_spmm on {on}")
        return (dict(err=err, on=on, bytes=_nbytes(*sa) + _nbytes(yp),
                     flops=2 * nnz_s, library=csr_mv(S_s, x2),
                     fn=lambda: bk.bell2_spmv_tiles(*sa, **kw_s),
                     plain=lambda: bk.bell2_spmv_tiles_plain(*sa, **kw_s)),
                dict(err=err_mm, on=f"{on}, B={RHS}", bytes=nbytes,
                     flops=RHS * 2 * nnz_s, library=library, fn=fn,
                     plain=plain))

    # B2 and B7 in bf16 on the float32 rows' plan (audikw reordered, its
    # values cast to bf16 on the card), and in float32 on the bf16 rows'
    # plan (audikw without reordering): each kernel in both types on one
    # plan
    _, d_r, xe_r = operands("audikw_proxy")
    (extra["bell2_spmv_bf16 on audikw_proxy reordered"],
     extra["bell2_spmm_bf16 on audikw_proxy reordered"]) = grid_rows(
        dataclasses.replace(d_r.far, vals=d_r.far.vals.to(torch.bfloat16)),
        "audikw_proxy reordered, values cast to bf16 (the float32 rows' "
        "plan)", ops.pad_x(xe_r, d_r.far.x_rows))
    A_n = bruns["audikw_proxy_bf16"][2].tuned
    _, d_n = A_n.pure_apply()
    xe_n = A_n.encode(torch.as_tensor(bruns["audikw_proxy_bf16"][1],
                                      device=dev))
    (extra["bell2_spmv on audikw_proxy without reordering"],
     extra["bell2_spmm on audikw_proxy without reordering"]) = grid_rows(
        d_n.far, "audikw_proxy without reordering, float32 (the bf16 rows' "
        "plan)", ops.pad_x(xe_n, d_n.far.x_rows))

    # B4 + B8 on the flagship's bf16 entry list (the kernel rows') and on
    # the hand-built one over 8-tile blocks with absent rows, cast to bf16:
    # onto Y planes at a plane stride past the plane whose rows no entry
    # names hold NaN and must keep it
    def entries_csr(es, T, x_rows):
        """An entry list as a float32 CSR tensor (its product with the
        flat padded x is what the entry kernel adds into its tiles)."""
        return torch.sparse_coo_tensor(
            torch.stack([es.rows.long(), es.cols.long()]), es.vals.float(),
            (T * 128, x_rows * 128)).coalesce().to_sparse_csr()

    def bf16_entries_check(es, x_rows, on, nnz_row):
        T = es.min_tiles
        named = torch.zeros(T * 128, dtype=torch.bool, device=dev)
        named[es.rows.long()] = True
        es_abs = dataclasses.replace(es, vals=es.vals.abs().double())
        worst = 0.0
        for B, mv in ((1, True), (1, False), (RHS, False), (11, False)):
            x3 = planes(B, x_rows)
            y0 = torch.rand((B, T * 128), generator=g).to(dev)
            y0[:, ~named] = float("nan")
            wide = poisoned((B, T + 3, 128))
            wide[:, :T] = y0.view(B, T, 128)
            if mv:
                bk.bell2_spmv_tiles_accum(es, x3[0], wide[0, :T])
            else:
                bk.bell2_spmm_tiles_accum(es, x3, wide[:, :T])
            torch.cuda.synchronize()
            got = wide[:, :T].reshape(B, -1)
            if (not torch.isnan(wide[:, T:]).all()
                    or not torch.isnan(got[:, ~named]).all()):
                raise AssertionError(f"bell2_spmm_accum bf16 on {on} B={B}: "
                                     "wrote a row no entry names, or past "
                                     "a plane")
            yp = bk.bell2_spmm_tiles_accum_plain(
                es, x3, y0.view(B, T, 128).clone()).reshape(B, -1)
            ys = bk.bell2_spmm_tiles_accum_plain(
                es_abs, x3.abs().double(),
                y0.view(B, T, 128).abs().double()).reshape(B, -1)
            worst = max(worst, _agree(got[:, named], yp[:, named],
                                      ys[:, named], nnz_row,
                                      f"entries bf16 on {on} B={B}"))
        print(f"kernels bell2_spmv_accum / bell2_spmm_accum bf16 on {on}: "
              f"{es.count} entries, B = 1, 1, 8, 11 onto strided planes "
              f"whose unnamed rows keep their NaN: max_abs_err vs twin "
              f"{worst}", flush=True)
        return worst

    es_hb = dataclasses.replace(es_h, vals=es_h.vals.to(torch.bfloat16))
    err_h = bf16_entries_check(es_hb, d_h.x_rows, "the hand-built list over "
                               "8-tile blocks with absent rows", 1.0)
    A, d, xe = bf_operands("flagship_bf16")
    esb = d.far.entries
    is_bf16(esb.vals)
    far_row = A.tuned.plan.far.nnz / A.nrows
    err = max(err_h, bf16_entries_check(esb, d.x_rows, "flagship bf16",
                                        far_row))
    x2d_fb = ops.pad_x(xe, d.x_rows)
    y0_fb = torch.rand((d.num_row_tiles, 128), generator=g).to(dev)
    S_eb = entries_csr(esb, d.num_row_tiles, d.x_rows)
    touched_b = int(torch.unique(esb.rows).numel())
    kern["bell2_spmv_accum_bf16"] = dict(
        err=err, on="flagship bf16",
        bytes=_nbytes(esb.rows, esb.cols, esb.vals, x2d_fb) + 8 * touched_b,
        flops=2 * esb.count, library=csr_mv(S_eb, x2d_fb),
        fn=lambda: bk.bell2_spmv_tiles_accum(esb, x2d_fb, y0_fb.clone()),
        plain=lambda: bk.bell2_spmv_tiles_accum_plain(esb, x2d_fb,
                                                      y0_fb.clone()))

    def make_acc_bf16(B, es=esb, T=d.num_row_tiles, x_rows=d.x_rows,
                      S=S_eb):
        x3 = planes(B, x_rows)
        y3 = planes(B, T, extra=3)
        es_abs = dataclasses.replace(es, vals=es.vals.abs().double())
        return (lambda: bk.bell2_spmm_tiles_accum(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(es, x3, y3.clone()),
                lambda: bk.bell2_spmm_tiles_accum_plain(
                    es_abs, x3.abs().double(), y3.abs().double()),
                _nbytes(es.rows, es.cols, es.vals, x3) + 8 * touched_b * B,
                csr_mv(S, x3))

    mm_pair("bell2_spmm_accum_bf16", make_acc_bf16, far_row, "flagship bf16",
            flops=RHS * 2 * esb.count)

    # B5 + B10 on near_band_paired's bf16 paired stream (the kernel rows')
    # and on the 49-block replan over 8-tile blocks cast to bf16: into
    # NaN-poisoned planes, and a zero x, which must give exact 0 in every
    # covered tile
    A, d, xe = bf_operands("near_band_paired_bf16")
    M_nb, xl_nb, Xe_nb = lib_bf16("near_band_paired")
    bt8_b = dataclasses.replace(d_bt8, vals=d_bt8.vals.to(torch.bfloat16))
    errs = []
    for dp, on, Bs in ((bt8_b, "near_band_paired, 8-tile blocks, bf16",
                        (2, 11, RHS)), (d, "near_band_paired bf16",
                                        (11, RHS))):
        is_bf16(dp.vals)
        TP, kw_p = paired_geometry(dp)
        pargs = (*paired_stream(dp), ops.pad_x(xe, dp.x_rows))
        yk = bk.sbell_spmv_tiles(*pargs, out=poisoned((TP, 128)), **kw_p)
        yp = bk.sbell_spmv_tiles_plain(*pargs, **kw_p)
        ys = bk.sbell_spmv_tiles_plain(dp.vals.abs(), *pargs[1:4],
                                       pargs[4].abs(), **kw_p)
        errs.append(_agree(yk, yp, ys, 2 * A.tuned.nnz_full / A.nrows,
                           f"sbell_spmv bf16 on {on}"))
        for B in (1, 11):
            zero = torch.zeros((B, dp.x_rows, 128), device=dev)
            got = bk.sbell_spmm_tiles(*paired_stream(dp), zero,
                                      out=poisoned((B, TP, 128)), **kw_p)
            torch.cuda.synchronize()
            if not torch.equal(got, torch.zeros_like(got)):
                raise AssertionError(f"sbell_spmm bf16 on {on}: a zero x "
                                     "did not give exact 0 everywhere")

        def make_sbell_bf16(B, dp=dp, TP=TP, kw_p=kw_p):
            sa = (*paired_stream(dp), planes(B, dp.x_rows, extra=2))
            return (lambda: bk.sbell_spmm_tiles(
                        *sa, out=poisoned((B, TP, 128)), **kw_p),
                    lambda: bk.sbell_spmm_tiles(*sa, **kw_p),
                    lambda: bk.sbell_spmm_tiles_plain(*sa, **kw_p),
                    lambda: bk.sbell_spmm_tiles_plain(
                        dp.vals.abs(), *sa[1:4], sa[4].abs(), **kw_p),
                    _nbytes(*sa) + 4 * B * TP * 128,
                    lambda: M_nb @ Xe_nb)

        mm_pair("sbell_spmm_bf16", make_sbell_bf16,
                2 * A.tuned.nnz_full / A.nrows, on, Bs=Bs,
                flops=RHS * 4 * nnz_of(dp.vals))
        print(f"kernel sbell_spmv bf16 on {on}: {dp.meta.shape[0]} chunks in "
              f"{TP // dp.tiles_per_block} blocks, max_abs_err vs twin "
              f"{errs[-1]}; a zero x at B = 1, 11 into NaN-poisoned planes "
              f"gives exact 0", flush=True)
    kern["sbell_spmv_bf16"] = dict(
        err=max(errs), on=f"near_band_paired bf16 TW={d.transpose_windows}",
        bytes=_nbytes(*pargs) + _nbytes(yp), flops=4 * nnz_of(d.vals),
        library=lambda: M_nb @ xl_nb,
        fn=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles(*a, **k),
        plain=lambda a=pargs, k=kw_p: bk.sbell_spmv_tiles_plain(*a, **k))

    # B6 + B12 on the ragged general_asym(g=50) plan cast to bf16, the
    # flagship as CSR and general_asym's bf16 peels (the kernel rows'): B6
    # adding onto nonzero y and storing from x itself into NaN-poisoned
    # tiles whose rows past the value blocks must read +0; B12 at B = 1,
    # 2, 4, 8, 11, X in place where it can be and copied, adding and
    # storing into strided planes
    bgen = {"general_asym(g=50) bf16": dataclasses.replace(
        gen_plans["general_asym(g=50)"],
        dia_vals=gen_plans["general_asym(g=50)"].dia_vals.to(torch.bfloat16))}
    for run_name in ("flagship_csr_bf16", "general_asym_bf16"):
        bgen[run_name] = bf_operands(run_name)[1]
    gerr = [0.0, 0.0]
    for on, dg in bgen.items():
        vals, offs, T = dg.dia_vals, dg.dia_offsets, dg.num_row_tiles
        is_bf16(vals)
        m = dg.ncols
        nv, D = vals.shape[0] * 1024, vals.shape[1]
        av = vals.abs().double()
        x = torch.rand(m, generator=g).to(dev)
        x2d = ops.pad_x(x, dg.x_rows)
        y0 = torch.rand((T, 128), generator=g).to(dev)
        e_add = _agree(sk.sdia_gen_tiles(vals, x2d, y0.clone(), offs),
                       sk.sdia_gen_tiles_plain(vals, x2d, y0.clone(), offs),
                       sk.sdia_gen_tiles_plain(av, x2d.abs().double(),
                                               y0.abs().double(), offs),
                       D, f"sdia_gen bf16 add on {on}")
        zk = sk.sdia_gen_tiles(vals, x, poisoned((T, 128)), offs, store=True)
        torch.cuda.synchronize()
        plus_zero_tail(zk[None], nv, f"sdia_gen bf16 store on {on}")
        e_st = _agree(zk, sk.sdia_gen_tiles_plain(vals, x, y0.clone(), offs,
                                                  store=True),
                      sk.sdia_gen_tiles_plain(av, x.abs().double(),
                                              y0.clone().double(), offs,
                                              store=True),
                      D, f"sdia_gen bf16 store on {on}")
        gerr[0] = max(gerr[0], e_add, e_st)
        said = []
        for B in (1, 2, 4, 8, 11):
            X = torch.rand((m, B), generator=g).to(dev)
            x3 = ops.pad_x_mm(X, dg.x_rows)
            y3 = planes(B, T, extra=3)
            yp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs)
            ys = sk.sdia_gen_tiles_mm_plain(av, x3.abs().double(),
                                            y3.abs().double(), offs)
            zp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs,
                                            store=True)
            zs = sk.sdia_gen_tiles_mm_plain(av, x3.abs().double(),
                                            y3.abs().double(), offs,
                                            store=True)
            worst = 0.0
            for xn, xil in (("copied", bk.interleave_x(X, dg.x_rows)),
                            ("gen_x", sk.gen_x(X, dg.x_rows))):
                what = f"sdia_gen_mm bf16 B={B} X {xn} on {on}"
                add = strided(y3, lambda y: sk.sdia_gen_tiles_mm(
                    vals, xil, y, offs, planes=B))
                st = strided(poisoned((B, T, 128)), lambda y: (
                    sk.sdia_gen_tiles_mm(vals, xil, y, offs, planes=B,
                                         store=True)))
                plus_zero_tail(st, nv, what)
                worst = max(worst, _agree(add, yp, ys, D, f"{what} add"),
                            _agree(st, zp, zs, D, f"{what} store"))
            said.append(f"B={B} {worst}")
            gerr[1] = max(gerr[1], worst)
        print(f"kernels sdia_gen / sdia_gen_mm bf16 on {on}: {D} diagonals, "
              f"max_abs_err vs twin B6 add {e_add}, store {e_st}; B12 "
              f"adding and storing, X in place and copied: "
              + "; ".join(said), flush=True)
    # the kernel rows: general_asym's store forms, as its applies run them
    dg = bgen["general_asym_bf16"]
    vals, offs, T, m = dg.dia_vals, dg.dia_offsets, dg.num_row_tiles, dg.ncols
    M_gb, xl_gb, Xe_gb = lib_bf16("general_asym")
    xg = torch.rand(m, generator=g).to(dev)
    yo = torch.empty((T, 128), device=dev)
    X8 = torch.rand((m, RHS), generator=g).to(dev)
    Y8 = torch.empty((RHS, T, 128), device=dev)
    xg8 = sk.gen_x(X8, dg.x_rows)
    kern["sdia_gen_bf16"] = dict(
        err=gerr[0], on="general_asym bf16 (store)", flops=2 * nnz_of(vals),
        library=lambda: M_gb @ xl_gb, bytes=_nbytes(vals, xg, yo),
        fn=lambda: sk.sdia_gen_tiles(vals, xg, yo, offs, store=True),
        plain=lambda: sk.sdia_gen_tiles_plain(vals, xg, yo, offs,
                                              store=True))
    kern["sdia_gen_mm_bf16"] = dict(
        err=gerr[1], on=f"general_asym bf16 (store, X in place), B={RHS}",
        flops=RHS * 2 * nnz_of(vals), library=lambda: M_gb @ Xe_gb,
        bytes=_nbytes(vals, X8, Y8),
        fn=lambda: sk.sdia_gen_tiles_mm(vals, xg8, Y8, offs, planes=RHS,
                                        store=True),
        plain=lambda: sk.sdia_gen_tiles_mm_plain(vals, xg8, Y8, offs,
                                                 planes=RHS, store=True))
    # the double instances of the paired and signed diagonal kernels (B5/B10
    # and B6/B12 in float64), which the float64 DistSpDMV runs (phase 8),
    # on the plans phase 8 applies: shard 1 of D5's float64 operator
    # (near_band_paired() under CFS_PAIRED=force, P = 4) and of D1's
    # mirrored float64 operator (cant_proxy(), CFS_DIST_SDIA_ROWS_MAX=8192,
    # P = 4), and on replans of both matrices without rows and columns
    # 20,000-29,999 (``holed``): the paired one over 8-tile output blocks,
    # the mirrored one as D1's operator's shard 1, which holds the absent
    # range. Each against its float64 twin (``F64_TWIN_TOL``): B5 into
    # NaN-poisoned tiles; B10 (``sbell_planes_kernel``, one launch and one
    # zero pass a group of up to 8 planes, checked in device launches at
    # B = 8) at B = 1, 2, 4, 8, 11 into NaN-poisoned strided planes, and a
    # zero x (every covered tile +0, nothing past a plane written); B6
    # adding onto a nonzero y and storing from x itself into NaN-poisoned
    # tiles whose rows past the value blocks must read +0; B12 (x staged
    # over the plan's window, ``sdia_gen_staged_kernel``) at B = 1, 2, 4,
    # 8, 11 from X in place and copied, adding and storing into strided
    # planes, and a zero X storing +0. The kernel rows (timed in phase 5
    # beside their bound, twin and library call: the float64 sparse CSR
    # product of the same stream, ``paired_csr`` and ``dia_csr``, held to
    # the twin first) are these kernels'.
    def double_instances():
        """The comparisons above; returns the float64 operators (their own
        scope: the kernel rows' closures of this phase read main's
        names when phase 5 calls them)."""
        from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
        from cfs_spmv_tpu_torch.parallel.mesh import make_mesh

        f64 = torch.float64
        t0 = time.perf_counter()
        dist64 = {}  # the float64 operators, applied again in phase 8

        def holed(csr):
            coo = csr.to_coo()
            keep = (((coo.row < 20_000) | (coo.row >= 30_000))
                    & ((coo.col < 20_000) | (coo.col >= 30_000)))
            return CSR.from_coo(COO(coo.nrows, coo.ncols, coo.row[keep],
                                    coo.col[keep], coo.val[keep],
                                    symmetric=coo.symmetric))

        for case, csr in (("D5 near_band_paired P=4 paired float64", nbp),
                          ("D1 cant_proxy P=4 mirrored float64", cant)):
            _, P, kw, env, _, _ = DIST_CASES[case]
            with _env(env):
                dist64[case] = DistSpDMV(csr, make_mesh(P, device="cuda:0"),
                                         **kw)
        dp64 = dist64["D5 near_band_paired P=4 paired float64"].shards[1].near
        if not (dp64.has_paired and dp64.vals.dtype == f64):
            raise AssertionError("D5's float64 shard 1 has no float64 paired "
                                 "stream")
        with _env({"CFS_PAIRED": "force"}):
            dh64 = ops.sym_to_device(build_sbell_plan(
                holed(nbp), dtype=np.float64, tiles_per_block=8,
                transpose_windows=dp64.transpose_windows, dia=False), dev)
        _, P, kw, env, _, _ = DIST_CASES["D1 cant_proxy P=4 mirrored float64"]
        with _env(env):
            dmh64 = DistSpDMV(holed(cant), make_mesh(P, device="cuda:0"),
                              **kw).shards[1].near
        if not (dh64.has_paired and dh64.vals.dtype == f64
                and len(torch.unique(dh64.step_block)) > 1):
            raise AssertionError("the paired replan has no float64 stream "
                                 "over several blocks")
        print(f"the float64 operators of D5 (paired) and D1 (mirrored) and "
              f"the replans with absent rows planned and uploaded in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        on_p = (f"D5 float64 shard 1 TW={dp64.transpose_windows}, "
                f"{dp64.meta.shape[0]} chunks")
        on_ph = (f"near_band_paired without rows 20,000-29,999 float64 "
                 f"TW={dh64.transpose_windows} BT=8, {dh64.meta.shape[0]} "
                 f"chunks in {len(torch.unique(dh64.step_block))} blocks")
        TP64, kw_p64 = paired_geometry(dp64)
        x64 = torch.rand(dp64.nrows, generator=g, dtype=f64).to(dev)
        pargs64 = (*paired_stream(dp64), ops.pad_x(x64, dp64.x_rows))
        yk = bk.sbell_spmv_tiles(*pargs64, out=poisoned((TP64, 128), f64),
                                 **kw_p64)
        yp = bk.sbell_spmv_tiles_plain(*pargs64, **kw_p64)
        ys = bk.sbell_spmv_tiles_plain(dp64.vals.abs(), *pargs64[1:4],
                                       pargs64[4].abs(), **kw_p64)
        npr_p = 2 * nnz_of(dp64.vals) / dp64.nrows
        e5 = _agree(yk, yp, ys, npr_p, f"sbell_spmv f64 on {on_p}")
        S_p64 = paired_csr(torch, dp64)
        xf64 = pargs64[4].reshape(-1)
        e_lib = _agree((S_p64 @ xf64)[:yp.numel()], yp.reshape(-1),
                       ys.reshape(-1), npr_p, f"paired_csr on {on_p}")
        kern["sbell_spmv_f64"] = dict(
            err=e5, on=on_p, bytes=_nbytes(*pargs64) + _nbytes(yp),
            flops=4 * nnz_of(dp64.vals), library=lambda: S_p64 @ xf64,
            fn=lambda: bk.sbell_spmv_tiles(*pargs64, **kw_p64),
            plain=lambda: bk.sbell_spmv_tiles_plain(*pargs64, **kw_p64))

        # B10 f64 as it ships: one launch and one zero pass a group of up
        # to 8 planes
        def ships_f64(dp, x3, y3):
            bk._launch_sbell(*paired_stream(dp), x3, y3, dp.chunks_per_step,
                             dp.tiles_per_block, dp.transpose_windows,
                             "sbell_spmm_tiles f64")
            return y3

        for dp, on in ((dh64, on_ph), (dp64, on_p)):
            TP, kw_q = paired_geometry(dp)
            C, TW = dp.meta.shape[0], dp.transpose_windows
            worst = 0.0
            for B in (1, 2, 4, 8, 11):
                x3 = planes(B, dp.x_rows, extra=2, dtype=f64)
                yp = bk.sbell_spmm_tiles_plain(*paired_stream(dp), x3, **kw_q)
                ys = bk.sbell_spmm_tiles_plain(
                    dp.vals.abs(), *paired_stream(dp)[1:], x3.abs(), **kw_q)
                wide = poisoned((B, TP + 3, 128), f64)
                ships_f64(dp, x3, wide[:, :TP])
                torch.cuda.synchronize()
                what = f"sbell_spmm f64 B={B} on {on}"
                if not torch.isnan(wide[:, TP:]).all():
                    raise AssertionError(f"{what}: wrote past a plane")
                worst = max(worst, _agree(
                    wide[:, :dp.num_row_tiles], yp, ys, npr_p, what))
            paired_zero_check(dp, on)
            x8 = planes(RHS, dp.x_rows, dtype=f64)
            y8 = torch.empty((RHS, TP, 128), device=dev, dtype=f64)
            n8 = _device_launches(torch, lambda: bk.sbell_spmm_tiles(
                *paired_stream(dp), x8, out=y8, **kw_q))
            if n8 != "2":
                raise AssertionError(f"sbell_spmm_tiles f64 B={RHS} on {on}: "
                                     f"{n8} device launches, not a kernel "
                                     "and a zero pass")
            pk = dp.packed.reshape(C, 8, 128).long()
            r2f = torch.gather((pk >> 7) & 7, 2, pk & 0x7F)
            rv, tv = r2f < TW, ((pk >> 7) & 7) < TW

            def busy(v):  # sublanes of a chunk where a warp has an entry
                return float(v.reshape(C, 8, 4, 32).any(-1).sum(1)
                             .double().mean())

            fill = (f"{float(rv.double().mean()):.3f} of the slots with a "
                    f"row entry, {float(tv.double().mean()):.3f} with a "
                    f"transpose entry; a warp has row entries in "
                    f"{busy(rv):.2f} of a chunk's 8 sublanes, transpose "
                    f"entries in {busy(tv):.2f}")
            print(f"kernel sbell_spmm f64 on {on} ({fill}): max_abs_err vs "
                  f"twin at B = 1, 2, 4, 8, 11 into NaN-poisoned strided "
                  f"planes {worst}; zero x (B = 1, 11): every covered tile "
                  f"zeroed, nothing past a plane written; walk "
                  f"{walk(dp, 1)} at B=1 and {walk(dp, RHS)} at B={RHS}, "
                  f"{_cuda.lib().cfs_sbell_smem(TW, 1, 1)} and "
                  f"{_cuda.lib().cfs_sbell_smem(TW, RHS, 1)} B of shared "
                  f"memory a CTA, {n8} device launches at B={RHS}",
                  flush=True)

        def make_sbell64_mm(B, dp=dp64):
            TP, kw_q = paired_geometry(dp)
            sa = (*paired_stream(dp),
                  planes(B, dp.x_rows, extra=2, dtype=f64))
            S = S_p64 if dp is dp64 else paired_csr(torch, dp)
            Xf = sa[4].reshape(B, -1).T.contiguous()
            return (lambda: bk.sbell_spmm_tiles(
                        *sa, out=poisoned((B, TP, 128), f64), **kw_q),
                    lambda: bk.sbell_spmm_tiles(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(*sa, **kw_q),
                    lambda: bk.sbell_spmm_tiles_plain(
                        dp.vals.abs(), *sa[1:4], sa[4].abs(), **kw_q),
                    _nbytes(*sa) + 8 * B * TP * 128,
                    lambda: S @ Xf)

        mm_pair("sbell_spmm_f64", lambda B: make_sbell64_mm(B, dh64), npr_p,
                on_ph, Bs=(1, 11, RHS))
        mm_pair("sbell_spmm_f64", make_sbell64_mm, npr_p, on_p,
                Bs=(1, 2, 4, 11, RHS), flops=RHS * 4 * nnz_of(dp64.vals))
        print(f"kernel sbell_spmv f64 on {on_p}: max_abs_err vs twin {e5}; "
              f"the library call's stream (paired_csr) against the twin "
              f"{e_lib}", flush=True)

        # B6 and B12 f64 on the mirrored shard and its replan
        def gen_check(dm, on):
            vals, offs = dm.dia_vals, dm.dia_offsets
            T, m = dm.num_row_tiles, dm.nrows
            nv, D = vals.shape[0] * 1024, vals.shape[1]
            win = dm.dia_window
            if not (dm.dia_mirrored and vals.dtype == f64 and win):
                raise AssertionError(f"{on}: no float64 mirrored diagonals "
                                     "whose x window is staged")
            av = vals.abs()
            x = torch.rand(m, generator=g, dtype=f64).to(dev)
            x2d = ops.pad_x(x, dm.x_rows)
            y0 = torch.rand((T, 128), generator=g, dtype=f64).to(dev)
            e_add = _agree(
                sk.sdia_gen_tiles(vals, x2d, y0.clone(), offs, window=win),
                sk.sdia_gen_tiles_plain(vals, x2d, y0.clone(), offs),
                sk.sdia_gen_tiles_plain(av, x2d.abs(), y0.abs(), offs),
                D, f"sdia_gen f64 add on {on}")
            zk = sk.sdia_gen_tiles(vals, x, poisoned((T, 128), f64), offs,
                                   store=True, window=win)
            torch.cuda.synchronize()
            plus_zero_tail(zk[None], nv, f"sdia_gen f64 store on {on}")
            e_st = _agree(zk, sk.sdia_gen_tiles_plain(
                vals, x, y0.clone(), offs, store=True),
                sk.sdia_gen_tiles_plain(av, x.abs(), y0.clone(), offs,
                                        store=True),
                D, f"sdia_gen f64 store on {on}")
            worst_mm, said = 0.0, []
            for B in (1, 2, 4, 8, 11):
                X = torch.rand((m, B), generator=g, dtype=f64).to(dev)
                x3 = ops.pad_x_mm(X, dm.x_rows)
                y3 = planes(B, T, extra=3, dtype=f64)
                yp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs)
                ys = sk.sdia_gen_tiles_mm_plain(av, x3.abs(), y3.abs(), offs)
                zp = sk.sdia_gen_tiles_mm_plain(vals, x3, y3.clone(), offs,
                                                store=True)
                zs = sk.sdia_gen_tiles_mm_plain(av, x3.abs(), y3.abs(), offs,
                                                store=True)
                forms = {"copied": bk.interleave_x(X, dm.x_rows)}
                xg = sk.gen_x(X, dm.x_rows)
                if xg.data_ptr() == X.data_ptr():
                    forms["in place"] = xg
                elif B in (1, 2, 4, 8):
                    raise AssertionError(f"sdia_gen_mm f64 on {on}: a "
                                         f"contiguous aligned X of B={B} was "
                                         "copied")
                worst = 0.0
                for xn, xil in forms.items():
                    what = f"sdia_gen_mm f64 B={B} X {xn} on {on}"
                    add = strided(y3, lambda y: sk.sdia_gen_tiles_mm(
                        vals, xil, y, offs, planes=B, window=win))
                    st = strided(poisoned((B, T, 128), f64), lambda y: (
                        sk.sdia_gen_tiles_mm(vals, xil, y, offs, planes=B,
                                             store=True, window=win)))
                    plus_zero_tail(st, nv, what)
                    worst = max(worst, _agree(add, yp, ys, D, f"{what} add"),
                                _agree(st, zp, zs, D, f"{what} store"))
                xil = forms["copied"]
                z3 = strided(poisoned((B, T, 128), f64), lambda y: (
                    sk.sdia_gen_tiles_mm(vals, torch.zeros_like(xil), y,
                                         offs, planes=B, store=True,
                                         window=win)))
                if z3.ne(0).any() or torch.signbit(z3).any():
                    raise AssertionError(f"sdia_gen_mm f64 B={B} on {on}: a "
                                         "zero X did not store +0")
                said.append(f"B={B} ({', '.join(forms)}) {worst}")
                worst_mm = max(worst_mm, worst)
            ships = sk.stage_slices(min(T * 128, nv), D,
                                    sk._thread_slots(dev))
            print(f"kernels sdia_gen / sdia_gen_mm f64 on {on}: {nv} value "
                  f"rows, {T * 128} y rows, window hi {win[0]} span "
                  f"{win[1]}; ships staged at {ships} slices a row, shared "
                  f"memory a CTA at B=1 and {RHS} by "
                  f"slices 1/2/4/8: " + ", ".join(
                      f"{_cuda.lib().cfs_sdia_gen_smem_f64(1, s_, 1)}/"
                      f"{_cuda.lib().cfs_sdia_gen_smem_f64(RHS, s_, 1)}"
                      for s_ in (1, 2, 4, 8))
                  + f" B; max_abs_err vs twin: B6 add {e_add}, store from x "
                  f"{e_st}; B12 adding and storing, by X: " + "; ".join(said)
                  + "; a zero X stores +0", flush=True)
            return x2d, y0, max(e_add, e_st), worst_mm

        gen_check(dmh64, "the mirrored cant_proxy without rows 20,000-29,999, "
                  "float64 shard 1")
        dm64 = dist64["D1 cant_proxy P=4 mirrored float64"].shards[1].near
        vals, offs, win = dm64.dia_vals, dm64.dia_offsets, dm64.dia_window
        T, m = dm64.num_row_tiles, dm64.nrows
        D = vals.shape[1]
        on_m = f"D1 mirrored float64 shard 1 ({D} diagonals)"
        x2d, y0, e6, e12 = gen_check(dm64, on_m)
        S_m64 = dia_csr(torch, vals, offs, T * 128, dm64.x_rows * 128)
        xf = x2d.reshape(-1)
        av = vals.abs()
        e_lib = _agree((S_m64 @ xf).reshape(T, 128),
                       sk.sdia_gen_tiles_plain(vals, x2d, torch.zeros_like(y0),
                                               offs),
                       sk.sdia_gen_tiles_plain(av, x2d.abs(),
                                               torch.zeros_like(y0), offs),
                       D, f"dia_csr on {on_m}")
        print(f"the library call's stream (dia_csr) on {on_m} against the "
              f"twin {e_lib}", flush=True)
        X8 = torch.rand((m, RHS), generator=g, dtype=f64).to(dev)
        Y8 = torch.rand((RHS, T, 128), generator=g, dtype=f64).to(dev)
        xg8 = sk.gen_x(X8, dm64.x_rows)
        X8f = ops.pad_x_mm(X8, dm64.x_rows).reshape(RHS, -1).T.contiguous()
        kern["sdia_gen_f64"] = dict(
            err=e6, on=f"{on_m} (add)", flops=2 * nnz_of(vals),
            bytes=_nbytes(vals, x2d) + 2 * _nbytes(y0),
            library=lambda: S_m64 @ xf,
            fn=lambda: sk.sdia_gen_tiles(vals, x2d, y0.clone(), offs,
                                         window=win),
            plain=lambda: sk.sdia_gen_tiles_plain(vals, x2d, y0.clone(), offs))
        kern["sdia_gen_mm_f64"] = dict(
            err=e12, on=f"{on_m} (add, X in place), B={RHS}",
            flops=RHS * 2 * nnz_of(vals),
            bytes=_nbytes(vals, X8) + 2 * _nbytes(Y8),
            library=lambda: S_m64 @ X8f,
            fn=lambda: sk.sdia_gen_tiles_mm(vals, xg8, Y8.clone(), offs,
                                            planes=RHS, window=win),
            plain=lambda: sk.sdia_gen_tiles_mm_plain(
                vals, xg8, Y8.clone(), offs, planes=RHS))
        return dist64

    dist64 = double_instances()
    phase_done("4 kernels against twins")

    # -- 5. times: kernels, then the kernel path against the plain path --
    def time_kernel(name, k):
        # the float64 kernels and the double instances
        f64 = "_df" in name or "_f64" in name
        k["ms"] = _median_ms(torch, k["fn"])
        k["plain_ms"] = _median_ms(torch, k["plain"])
        k["library_ms"] = _median_ms(torch, k["library"])
        k["device_ms"], k["device"] = _device_ms(torch, k["fn"])
        k["library_device_ms"], _ = _device_ms(torch, k["library"])
        k["bound_ms"], k["bound_by"] = _bound(
            k["bytes"], k["flops"], "float64" if f64 else "float32")
        print(f"kernel {name.split(' on ')[0]} on {k['on']}: max_abs_err "
              f"vs twin {k['err']} "
              f"kernel {k['ms']:.4f} ms twin {k['plain_ms']:.4f} ms "
              f"library call {k['library_ms']:.4f} ms (device "
              f"{_ms(k['library_device_ms'])}); "
              f"{_fmt_device(k['device_ms'], k['device'])}; "
              f"{k['bytes'] / 1e6:.2f} MB of operands and "
              f"{k['flops'] / 1e6:.2f} Mflop -> bound {k['bound_ms']:.4f} "
              f"ms by {k['bound_by']} (HBM rate; operands under 50 MB "
              f"can sit in L2), {k['bytes'] / k['ms'] / 1e6:.0f} GB/s by "
              f"event time ({card})", flush=True)

    for name, k in kern.items():
        time_kernel(name, k)
    for name, k in big.items():  # the paired kernels past the L2
        time_kernel(name, k)
    for name, k in dense.items():  # the grid kernels on general_asym f64
        time_kernel(name, k)
    for name, k in extra.items():  # the other plans' rows of PERF.md
        time_kernel(name, k)
    # the stream read once for 8 right-hand sides against 8 reads: the
    # MM(8) kernel's device time beside 8x its SpMV form's, same plan
    for ks, mm, mv, kernel in (
            (kern, "bell2_spmm", "bell2_spmv", "bell2_spmv_kernel"),
            (kern, "sbell_spmm", "sbell_spmv", "sbell_spmv_kernel"),
            (big, "sbell_spmm", "sbell_spmv", "sbell_spmv_kernel"),
            (kern, "sdia_sym_mm", "sdia_sym", "sdia_sym_kernel"),
            (kern, "bell2_spmm_accum", "bell2_spmv_accum",
             "bell2_entries_kernel"),
            (kern, "bell2_spmm_df", "bell2_spmv_df", "bell2_spmv_kernel"),
            (dense, "bell2_spmm_df", "bell2_spmv_df", "bell2_spmv_kernel"),
            (kern, "bell2_spmm_accum_df", "bell2_spmv_accum_df",
             "bell2_entries_kernel"),
            (kern, "sdia_sym_df_mm", "sdia_sym_df", "sdia_sym_kernel"),
            (kern, "sbell_spmm_f64", "sbell_spmv_f64", "sbell_planes_kernel"),
            (kern, "sdia_gen_mm_f64", "sdia_gen_f64",
             "sdia_gen_staged_kernel")):
        t_mm = ks[mm]["device"].get(kernel)
        # the float SpMV instance of the grid kernel is the walk groups'
        # kernel, the double paired one sbell_spmv_kernel
        t_mv = ks[mv]["device"].get(
            {"bell2_spmv": "bell2_walks_kernel",
             "sbell_spmv_f64": "sbell_spmv_kernel"}.get(mv, kernel))
        print(f"MM({RHS}) vs {RHS}x SpMV device time, {kernel} on "
              f"{ks[mv]['on']}: MM({RHS}) {_ms(t_mm)} ms, SpMV {_ms(t_mv)} "
              f"ms, ratio MM / ({RHS} SpMV) "
              f"{_ratio(t_mm, t_mv and RHS * t_mv)} ({card})", flush=True)
    graphed = {}  # run -> (eager ms, graphed ms, device ms) per apply
    for name in RUNS:
        A, d, xe = operands(name)
        apply, apply_mm = {
            ops.Bell2Device: (ops.bell2_apply, ops.bell2_apply_mm),
            ops.SBellDevice: (ops.sbell_apply, ops.sbell_apply_mm),
            ops.Fp64Device: (ops.fp64_apply, ops.fp64_apply_mm),
        }[type(d)]
        yk = apply(d, xe)
        yp = apply(d, xe, plain=True)
        e2e_err = float((yk - yp).abs().max())
        ms_k = _median_ms(torch, lambda: apply(d, xe))
        ms_p = _median_ms(torch, lambda: apply(d, xe, plain=True))
        busy, by_name = _device_ms(torch, lambda: apply(d, xe))
        # the same apply as utils/timing.time_matvec times it: GRAPH_ITERS
        # applies captured into one CUDA graph, replayed between events
        ms_g = time_matvec(A.tuned, torch.as_tensor(runs[name][1],
                                                    device=dev),
                           iters=GRAPH_ITERS) * 1e3
        # the card's busy time in such a graph's replays, per apply
        g_apply = capture(lambda: apply(d, xe), GRAPH_ITERS)
        busy_g = trace.device_busy_s(g_apply.replay, calls=2)
        busy_g = None if busy_g is None else busy_g * 1e3 / GRAPH_ITERS
        del g_apply
        graphed[name] = (ms_k, busy, ms_g, busy_g)
        nnz = A.tuned.nnz_full
        print(
            f"end to end {name}: kernel path {ms_k:.4f} ms "
            f"({nnz / ms_k / 1e6:.2f} Gnnz/s), plain path {ms_p:.4f} ms "
            f"({nnz / ms_p / 1e6:.2f} Gnnz/s), max |kernel - plain| "
            f"{e2e_err}; kernel path {_fmt_device(busy, by_name)}; "
            f"graphed (time_matvec) {ms_g:.4f} ms per apply "
            f"({nnz / ms_g / 1e6:.2f} Gnnz/s), device {_ms(busy_g)} ms; "
            f"idle share eager {_share(busy and 1 - busy / ms_k)}, "
            f"graphed {_share(busy_g and 1 - busy_g / ms_g)}; "
            f"n={A.nrows} nnz_full={nnz} ({card})",
            flush=True,
        )
        # SpMM(8): the MM kernel path, its plain path, and 8 SpMV applies
        Xe = torch.rand((A.ncols, RHS), generator=g, dtype=xe.dtype).to(dev)
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
            f"{_ms(busy_8)} ms, ratio {_ratio(busy_mm, busy_8)} ({card})",
            flush=True,
        )
        # device launches per apply
        said = [f"{what} {_device_launches(torch, lambda: fn(d, x_))} "
                f"launches"
                for what, fn, x_ in (("SpMV", apply, xe),
                                     (f"SpMM({RHS})", apply_mm, Xe))]
        print(f"launches {name} per apply (profiler): " + "; ".join(said)
              + f" ({card})", flush=True)
    # one kernel, one stream, other addresses: cant_proxy() NONE's stream
    # kernel on fresh copies of its operands, each made after a further
    # allocation that stays held, to tell what a reading owes to where
    # the operands lie from what it owes to the code
    A, d, xe = operands("cant_proxy_none")
    held, reads = [], []
    for mb in (0, 2, 6, 14, 30, 62):
        held.append(torch.empty(mb << 20, dtype=torch.uint8, device=dev))
        copy = [t.clone() for t in (d.vals, d.packed, d.meta, d.step_block,
                                    ops.pad_x(xe, d.x_rows))]
        _, by = _device_ms(
            torch, lambda: bk.bell2_spmv_tiles(*copy, **d.stream_kw()))
        reads.append(_ms(by.get("bell2_walks_kernel")))
        held.append(copy)  # the next copies land elsewhere
    print(f"placement cant_proxy_none: bell2_walks_kernel device ms on six "
          f"copies of one stream: {', '.join(reads)} ({card})", flush=True)
    del held, copy
    # the library call for each whole matrix: one sparse CSR product
    for mname, csr in mats.items():
        said = []
        for dt in (torch.float32, torch.float64):
            M, xv, Xv = lib_operands(mname, dt)
            for what, fn in (("SpMV", lambda: M @ xv),
                             (f"SpMM({RHS})", lambda: M @ Xv)):
                ms = _median_ms(torch, fn)
                busy, _ = _device_ms(torch, fn)
                said.append(f"{str(dt)[6:]} {what} {ms:.4f} ms (device "
                            f"{_ms(busy)})")
        print(f"library torch.sparse_csr_tensor(A) @ x on {mname} "
              f"(n={csr.nrows}): " + ", ".join(said) + f" ({card})",
              flush=True)
    print("graphed applies (ms per SpMV apply: eager wall / its device "
          "time; utils/timing.time_matvec's graphed wall / its device "
          "time): " + ", ".join(
              f"{k} {e:.4f} / {_ms(be)}; {g_:.4f} / {_ms(bg)}"
              for k, (e, be, g_, bg) in graphed.items()) + f" ({card})",
          flush=True)
    # the bf16 applies beside the float32 ones of the same matrix and x:
    # eager wall (CUDA events, 20 calls), graphed (time_matvec) and device
    # time per SpMV apply, the SpMM(8) apply's device time, and the bytes
    # each plan streams
    bf16_e2e = {}
    for name, (A, x, A32) in bruns.items():
        said = {}
        for label, tm in (("float32", A32.tuned), ("bf16", A.tuned)):
            fn, dv_ = tm.pure_apply()
            xe = tm.encode(torch.as_tensor(x, device=dev))
            fnm, dvm = tm.pure_apply_mm()
            Xe = tm.encode(torch.rand((A.ncols, RHS), generator=g).to(dev))
            ms_e = _median_ms(torch, lambda: fn(dv_, xe))
            busy, by = _device_ms(torch, lambda: fn(dv_, xe))
            ms_g = time_matvec(tm, torch.as_tensor(x, device=dev),
                               iters=GRAPH_ITERS) * 1e3
            busy_mm, _ = _device_ms(torch, lambda: fnm(dvm, Xe))
            said[label] = (ms_e, busy, ms_g, busy_mm, tm.stream_bytes(), by)
        bf16_e2e[name] = said
        f, b = said["float32"], said["bf16"]
        print(f"end to end {name} against float32 (ms per apply: eager "
              f"wall, device, graphed wall; SpMM({RHS}) device): float32 "
              f"{f[0]:.4f}, {_ms(f[1])}, {f[2]:.4f}; {_ms(f[3])}; bf16 "
              f"{b[0]:.4f}, {_ms(b[1])}, {b[2]:.4f}; {_ms(b[3])}; device "
              f"ratio bf16 / float32 SpMV {_ratio(b[1], f[1])}, SpMM "
              f"{_ratio(b[3], f[3])}; stream_bytes {f[4]} -> {b[4]} "
              f"({b[4] / f[4]:.3f}x); bf16 {_fmt_device(b[1], b[5])} "
              f"({card})", flush=True)
    # the plan cache on the card: cant_proxy() tuned in bf16 twice into
    # one directory; the second tune loads the first's file, and its
    # apply equals the first's bit for bit (B1 adds without atomics)
    from cfs_spmv_tpu_torch.io import plancache

    cache_dir = os.path.join(_smoke_dir(), "plancache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    loads, load_plan = [], plancache.load_plan
    plancache.load_plan = lambda p: (loads.append(p), load_plan(p))[1]
    try:
        t0 = time.perf_counter()
        tc1 = tune(cant, fmt=Format.SSS, values="bfloat16",
                   cache_dir=cache_dir)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        tc2 = tune(cant, fmt=Format.SSS, values="bfloat16",
                   cache_dir=cache_dir)
        t_second = time.perf_counter() - t0
    finally:
        plancache.load_plan = load_plan
    files = os.listdir(cache_dir)
    xc = torch.as_tensor(runs["cant_proxy"][1], device=dev)
    same = torch.equal(tc1.matvec(xc), tc2.matvec(xc))
    print(f"plan cache on the card: cant_proxy() bf16 tuned twice into one "
          f"directory: {len(files)} file(s) of "
          f"{sum(os.path.getsize(os.path.join(cache_dir, f)) for f in files)}"
          f" bytes, {len(loads)} load(s); tune+upload {t_first:.2f} s built, "
          f"{t_second:.2f} s loaded; the loaded plan's SpMV bit-identical to "
          f"the built one's: {same}; values on the card "
          f"{tc2.operands.dia_vals.dtype}", flush=True)
    if (len(files) != 1 or len(loads) != 1 or not same
            or tc2.operands.dia_vals.dtype != torch.bfloat16):
        raise AssertionError("the plan cache missed, or its plan gave "
                             "another result")
    shutil.rmtree(cache_dir)
    phase_done("5 times")

    # -- 5b. the row-major float64 SpMM at hpcg-256's shape --------------
    hpcg_rows_phase(torch)
    phase_done("5b hpcg-256 row-major SpMM")

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
        rc = test_cli([path, "1"])  # --device defaults to cuda
    said = buf.getvalue().strip()
    print(f"cli test_spmv_mmf {path} 1: {said!r} exit {rc}", flush=True)
    if rc != 0 or not said.endswith("PASSED!"):
        raise AssertionError("the differential CLI did not pass")
    # the entry points with no device named land on the card
    small = CSR.from_coo(coo)
    xs = np.random.default_rng(3).uniform(1.0, 2.0, small.ncols).astype(
        np.float32)
    A = SparseMatrix.create(small, Format.SSS)
    y = A @ xs  # untuned, a numpy x
    where = [y.device.type, A.tuned.device.type,
             A.tune().tuned.device.type, tune(small).device.type]
    ok, err, _ = oracle_ok(y.cpu().numpy(), small, xs.astype(np.float64),
                           A.tuned.nnz_full, np.float32)
    print(f"default device: untuned A @ numpy x, its tuned matrix, "
          f"A.tune() and tune(csr) on {where}; A @ x max_abs_err={err} "
          f"oracle_ok={ok}", flush=True)
    if where != ["cuda"] * 4 or not ok:
        raise AssertionError("an entry point's default is not the card")
    phase_done("6 cli and default device")

    # -- 7. the solvers at full width, graphed against eager ------------
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "examples"))
    from cg_poisson_torch import laplacian_2d

    t0 = time.perf_counter()
    lap = {}
    for dt in (np.float32, np.float64):
        A = SparseMatrix.create(laplacian_2d(SOLVER_GRID), Format.SSS)
        op = SpDMV(A, Tuning.AGGRESSIVE, dtype=dt)
        x_true = np.random.default_rng(0).standard_normal(A.nrows).astype(dt)
        lap[np.dtype(dt).name] = (A.tuned, A.diagonal().astype(dt),
                                  op(x_true))
    gasym_b = {}
    for dname, run in (("float32", "general_asym"),
                       ("float64", "general_asym_f64")):
        A, _ = runs[run]
        x_true = np.random.default_rng(0).uniform(-1.0, 1.0, A.ncols)
        gasym_b[dname] = (A.tuned, A.tuned.matvec(torch.as_tensor(
            x_true, dtype=A.tuned.dtype, device=dev)))
    A32 = lap["float32"][0]
    print(f"solver matrices: the {SOLVER_GRID}x{SOLVER_GRID} Laplacian, "
          f"n={A32.nrows} nnz_full={A32.nnz_full}, float32 and float64, "
          f"planned and uploaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    solver_phase(torch, card, wrappers, launches, lap, gasym_b,
                 runs["cant_proxy"][0].tuned)
    # S1 with bfloat16 values: the Laplacian's values (4 on the diagonal,
    # which stays float32, and -1) are exact in bf16, so the graphed solve
    # should equal the float32 one bit for bit, iteration for iteration
    from cfs_spmv_tpu_torch.models import solvers
    from cfs_spmv_tpu_torch.utils import trace

    t32_, _, b32_ = lap["float32"]
    t0 = time.perf_counter()
    A_bf = SparseMatrix.create(laplacian_2d(SOLVER_GRID), Format.SSS)
    SpDMV(A_bf, Tuning.AGGRESSIVE, values="bfloat16")
    t_bf = A_bf.tuned
    t_plan = time.perf_counter() - t0
    iters = SOLVES["S1 cg float32"][0]
    for w in wrappers.values():
        w.launches = 0
    with trace.recording():
        out_bf = solvers.cg(t_bf, b32_, iters=iters)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items() if w.launches}
    replays = trace.collect().counters.get("solve.replays", 0)
    wall_bf = _loop_ms(solvers)
    for k, c in counts.items():
        launches[k] += c
    out_32 = solvers.cg(t32_, b32_, iters=iters)
    wall_32 = _loop_ms(solvers)
    h_bf, h_32 = out_bf[-1], out_32[-1]
    identical = all(torch.equal(a, b) for a, b in zip(out_bf, out_32))
    differ = torch.nonzero(h_bf != h_32).reshape(-1)
    first = (f"first difference at history entry {int(differ[0])}: bf16 "
             f"{float(h_bf[differ[0]])!r}, float32 {float(h_32[differ[0]])!r}"
             if len(differ) else "no history entry differs")
    dev_h = _rel_agree(h_32, h_bf)
    print(f"solver S1 cg float32 with bfloat16 values: {iters} iterations, "
          f"{replays} graph replays, planned and uploaded in {t_plan:.2f} s "
          f"(stream_bytes {t_bf.stream_bytes()} against "
          f"{t32_.stream_bytes()}); wall per iteration graphed {wall_bf:.4f} "
          f"ms against float32 values {wall_32:.4f} ms; bit-identical to the "
          f"float32 solve (x and history): {identical}; {first}; max "
          f"relative history difference {dev_h:.3g}; residual "
          f"{float(h_bf[0]):.4g} -> {float(h_bf[-1]):.4g}; launched "
          f"{counts} ({card})", flush=True)
    if set(counts) != {"sdia_sym_bf16"} or replays != iters:
        raise AssertionError("S1 bf16: launched other kernels than B1's "
                             "bf16 instance, or replayed its graph other "
                             "than once an iteration")
    if dev_h > SOLVE_TOL["float32"] or not torch.isfinite(out_bf[0]).all():
        raise AssertionError("S1 bf16: disagrees with the float32 solve")
    example = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "cg_poisson_torch.py")
    res = subprocess.run([sys.executable, example], capture_output=True,
                         text=True, timeout=600)
    print(f"example {os.path.basename(example)} (g = 256): "
          f"{res.stdout.strip()!r} exit {res.returncode}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the CG example failed: {res.stderr[-2000:]}")
    phase_done("7 solvers")

    # -- 8. the distributed layer on P shards of card 0 ------------------
    dist_phase(torch, card, counted, oracle_ok,
               dict(cant=cant, audikw=audikw, gasym=gasym, st27=st27,
                    nbp=nbp), runs, wrappers, launches,
               {**dist64, "D3 general_asym P=4": d3_op})
    phase_done("8 distributed")

    # -- 9. one NCCL rank over a process-group mesh ---------------------
    out = os.path.join(_smoke_dir(), "nccl_rank.json")
    if os.path.exists(out):
        os.remove(out)
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--nccl-rank", out],
        capture_output=True, text=True, timeout=NCCL_TIMEOUT)
    for line in res.stdout.splitlines():
        print(line, flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the NCCL rank failed (exit {res.returncode})"
                             f":\n{res.stderr[-4000:]}")
    with open(out) as f:
        for k, c in json.load(f)["launches"].items():
            launches[k] += c
    phase_done("9 one NCCL rank")
    print(f"launch counts of every main path: {launches}", flush=True)
    idle = sorted(k for k, c in launches.items() if not c)
    if idle:
        raise AssertionError(f"kernels launched on no main path: {idle}")
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
            "bound_ms": kern[name]["bound_ms"],
            "bound_by": kern[name]["bound_by"],
            "library_ms": kern[name]["library_ms"],
            # beyond the event times above (wrapper overhead included):
            # the card's own time from the profiler (an accumulated y's
            # clone included), null if it saw no device events
            "device_ms": kern[name]["device_ms"],
            "library_device_ms": kern[name]["library_device_ms"],
            "on": kern[name]["on"],
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
    try:
        if sys.argv[1:2] == ["--nccl-rank"]:
            sys.exit(nccl_rank(sys.argv[2]))
        sys.exit(main())
    finally:
        for started in _STARTED:
            if started.poll() is None:
                started.kill()
