"""The tuning dispatcher: CSR → device-ready tuned plan.

Port of ``cfs_spmv_tpu/tuning/tune.py``. In float32: the tuned symmetric
path (``Format.SSS``/``HYB`` under ``Tuning.AGGRESSIVE``: triangle split
+ dense-diagonal peel + paired/far layout, ``formats/sbell``, bound to
``ops/spmv.sbell_apply``) and the general path (``Format.CSR``/``BELL``/
``COO``, or ``Tuning.NONE``: symmetric input expanded, signed-offset
diagonal peel under aggressive tuning, ``formats/bell2.build_general_plan``,
bound to ``ops/spmv.bell2_apply``), with the optional RCM permutation
around either. Each path binds its SpMM applier beside it
(``sbell_apply_mm``, ``bell2_apply_mm``): one plan serves both.
``Format.BSR`` keeps its host block container and runs one of the two.

In float64 (``dtype=np.float64``), as in the reference, one route serves
every format and tuning level, with no reordering: ``_tune_fp64`` peels
the dense lower diagonals of a symmetric matrix (the main one included,
stored halved) into the symmetric diagonal stream and packs everything
else, expanded, into one one-sided stream, both in IEEE double
(``ops/spmv.fp64_apply``). Past ``FP64_ENTRIES_MIN_NNZ`` stored entries
the residual of a symmetric matrix whose peel takes diagonals is an entry
list built from the lower triangle, with no slot search
(``ops/fp64_entries.Fp64EntriesPlan``).
``CFS_FP64=xla`` selects the plain ELL+COO path instead
(``_tune_fp64_xla``, ``ops/xla_ref.py``).

``values="bfloat16"`` stores the float32 plans' stream values in
bfloat16 (``_cast_values``, as the reference's): the paired or one-sided
stream's, the far stream's and the diagonal planes', rounded to nearest
even and held on the host as their bits (``io/plancache.BF16_BITS``); x, y,
``diag``, every sum and ``TunedMatrix.dtype`` stay float32. The float64
route ignores ``values``, as the reference's returns before the cast.

``cache_dir`` (default ``config.plan_cache_dir``, ``CFS_PLAN_CACHE``)
caches each plan with ``io/plancache.cached_build`` under the reference's
key for the float32 plans, so the two packages can share one directory;
the float64 plan (native double, not the reference's double-float pairs)
has a key of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..formats.bell2 import LANES, SUBLANES, Bell2Plan
from ..formats.csr import CSR
from ..formats.sbell import build_sbell_plan
from ..io.plancache import cached_build
from ..ops import spmv as spmv_ops
from ..ops.fp64_entries import Fp64EntriesPlan
from ..utils import trace
from ..utils.config import config
from ..utils.logging import info, warn
from ..utils.platform import Format, Kernel, Tuning

__all__ = ["TunedMatrix", "tune"]

#: stored entries (the lower triangle's) past which a float32 symmetric
#: plan is built without the planner's relaxed slot search
#: (``build_sbell_plan(allow_relax=False)``: no degree grouping, no deep
#: windows). That search packs the far stream up to eight times over: its
#: layout took 66 s of a 143-s cold set-up at 16.75M stored entries on the
#: card's host, 24 s without it (PERF.md, §6); and the far stream of a
#: plan it does not group reaches the card as its live entries, whatever
#: the chunk layout it chose
RELAX_MAX_NNZ = 1 << 23

#: stored entries past which a symmetric matrix whose peel takes diagonals
#: builds its float64 residual as an entry list
#: (``build_fp64_plan(entries=True)``): no slot search and no chunk grid,
#: which the upload compacts to the same entries there. On an H100 and its
#: 8-core host (PERF.md, §6): at 29.9M stored entries of a 3-D elasticity
#: matrix both forms applied in 0.36 ms and the grid took 41 s to build,
#: the entry list 1.6 s (at 248M: 330 s and 52 GB against 14.5 s); at
#: 3.5M the grid applied in 0.10 ms, the entry list 0.15. Past the gate an
#: unpeeled matrix keeps the grid: grouped, it applied 20% faster (0.20
#: against 0.25 ms at 18.9M stored)
FP64_ENTRIES_MIN_NNZ = 1 << 23


@dataclasses.dataclass
class TunedMatrix:
    """A tuned, device-resident matrix with bound apply functions.

    The analog of a tuned ``CSRMatrix`` with its ``spmv_fn`` pointer bound
    (``csr_matrix.hpp:124``). The appliers are plain functions of
    (operands, x) and (operands, X), so solvers and timing loops can hold
    the operands and call them directly (``pure_apply``,
    ``pure_apply_mm``).
    """

    format: Format
    nrows: int
    ncols: int
    nnz_full: int
    symmetric: bool
    plan: object
    operands: object  # device struct (or dict of it + permutations)
    _apply_mv: Callable  # (operands, x) -> y
    _apply_mm: Callable  # (operands, X) -> Y, X (ncols, B)
    spill_fraction: float  # far-stream fraction for symmetric plans
    padding_ratio: float
    device: torch.device
    perm: np.ndarray | None = None  # RCM row order, if applied
    bsr: object | None = None  # BSR host container when fmt=BSR
    #: un-permuted appliers (mv, mm) + operands when RCM is applied (the
    #: wrapped appliers pay two row gathers per call — solvers work in
    #: permuted space via pure_apply + encode/decode)
    _inner: tuple | None = None
    #: the type of x, y and the stored values
    dtype: torch.dtype = torch.float32

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("cfs.apply", rhs=1, dtype=self.dtype):
            return self._apply_mv(self.operands, x)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("cfs.apply", rhs=x.shape[-1], dtype=self.dtype):
            return self._apply_mm(self.operands, x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``matvec`` for a 1-D x, else ``matmat``, inside the caller's
        ``cfs.apply`` span (the entry points that convert x first)."""
        if x.ndim != 1:
            return self._apply_mm(self.operands, x)
        return self._apply_mv(self.operands, x)

    def pure_apply(self):
        """(fn, operands) with fn a plain function of its arguments. When
        RCM reordering is active the returned fn works in PERMUTED space:
        feed it ``encode(x)`` and ``decode`` the result (norms are
        permutation-invariant, so solver scalars need no translation)."""
        if self._inner is not None:
            mv, _, ops = self._inner
            return mv, ops
        return self._apply_mv, self.operands

    def pure_apply_mm(self):
        """:meth:`pure_apply` for the SpMM applier (rows of X permute
        like x)."""
        if self._inner is not None:
            _, mm, ops = self._inner
            return mm, ops
        return self._apply_mm, self.operands

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """User space → internal (permuted) space (rows of a 2-D X too)."""
        if self.perm is None:
            return x
        return torch.index_select(x, 0, self.operands["p"])

    def decode(self, y: torch.Tensor) -> torch.Tensor:
        """Internal (permuted) space → user space."""
        if self.perm is None:
            return y
        return torch.index_select(y, 0, self.operands["ip"])

    def stream_bytes(self) -> int:
        return self.plan.stream_bytes()


def tune(
    csr: CSR,
    *,
    fmt: Format = Format.NONE,
    kernel: Kernel = Kernel.SpDMV,
    tuning: Tuning = Tuning.AGGRESSIVE,
    dtype=np.float32,
    cache_dir: str | None = None,
    reorder: bool | str = "auto",
    values: str = "same",
    device="cuda",
) -> TunedMatrix:
    """Select a layout and build the tuned matrix on ``device`` (the card
    by default; ``RuntimeError`` where CUDA is absent, never the CPU
    instead).

    Format selection mirrors the reference factory
    (``sparse_matrix.tpp:14-24``): ``SSS``/``HYB`` require symmetric
    storage; ``NONE`` auto-picks SSS for symmetric matrices under
    aggressive tuning, else the general BELL2 path. ``Tuning.NONE`` on a
    symmetric matrix expands it and runs the one-sided stream (the
    untuned-oracle path of the reference's differential tests,
    ``test_spmv_mmf.cpp:85-89``).

    ``reorder``: bandwidth-reducing RCM permutation, under aggressive
    tuning of a square matrix. ``"auto"`` applies it only when it shrinks
    the mean bandwidth 2x on a scattered matrix; ``True`` forces,
    ``False`` disables.

    ``kernel`` does not change the plan: both appliers are bound.

    ``dtype=np.float64`` takes the float64 route whatever ``tuning``,
    ``reorder`` and ``values`` say (the reference returns before all
    three): the native fp64 kernels, or the plain ELL+COO path under
    ``CFS_FP64=xla``; x and y are then ``torch.float64``.

    ``values="bfloat16"`` (float32 only) stores the stream values in
    bfloat16, half the bytes; x, y, the sums and ``dtype`` stay float32,
    and results carry a 2-byte type's tolerance. ``cache_dir`` (default
    ``config.plan_cache_dir``; empty: no cache) loads the plan from there
    when it holds one for this matrix and these parameters, else saves
    the one built.
    """
    del kernel
    with trace.span("cfs.tune", dtype=np.dtype(dtype).name,
                    nrows=csr.nrows, nnz=csr.nnz) as span:
        device = spmv_ops.as_device(device)
        if cache_dir is None:
            cache_dir = config.plan_cache_dir
        if fmt == Format.NONE:
            fmt = (
                Format.SSS
                if (csr.symmetric and tuning == Tuning.AGGRESSIVE)
                else Format.CSR
            )
        bsr = None
        if fmt == Format.BSR:
            # BSR is a host-format contract (block detection + 1/b² index
            # storage, formats/bsr.py); the tuned execution path is shared
            from ..formats.bsr import BSR, detect_block_size

            bsr = BSR.from_csr(csr, detect_block_size(csr))
            fmt = Format.SSS if csr.symmetric else Format.CSR
        if fmt in (Format.SSS, Format.HYB) and not csr.symmetric:
            raise ValueError(f"format {fmt} requires a symmetric matrix")
        if values not in ("same", "bfloat16"):
            raise ValueError(
                f"values must be 'same' or 'bfloat16', got {values}")
        if np.dtype(dtype) == np.float64:
            if config.fp64_path not in ("df", "xla"):
                raise ValueError(
                    f"CFS_FP64 must be 'df' or 'xla', got {config.fp64_path!r}"
                )
            if config.fp64_path == "xla":
                return _tune_fp64_xla(csr, fmt, device)
            tuned = _tune_fp64(csr, fmt, device, cache_dir)
            dia = tuned.plan.dia
            form, nnz, slots = _fp64_stream(tuned)
            span.set(fp64_plan="expanded" if dia is None else "sdia",
                     sdia_diagonals=0 if dia is None else len(dia.offsets),
                     fp64_stream=form, fp64_stream_slots=slots)
            trace.count("tune.fp64_peeled", int(dia is not None))
            trace.count("tune.fp64_nnz", tuned.nnz_full)
            trace.count("tune.fp64_stream_nnz", nnz)
            return tuned
        if np.dtype(dtype) != np.float32:
            raise ValueError(
                f"dtype must be float32 or float64, got {np.dtype(dtype)}"
            )
        perm = None
        if (reorder and tuning == Tuning.AGGRESSIVE and csr.nrows == csr.ncols
                and csr.nnz):
            from .reorder import choose_reorder

            with trace.span("cfs.plan.reorder", log=True) as rs:
                res, bw0, bw1 = choose_reorder(
                    csr, min_gain=2.0 if reorder == "auto" else 1.0
                )
                rs.set(rcm=res is not None, bw_before=bw0, bw_after=bw1,
                       bw_gain=bw0 / bw1 if bw1 else 1.0)
            if res is not None:
                perm, csr = res

        if fmt in (Format.SSS, Format.HYB) and tuning == Tuning.AGGRESSIVE:
            # past RELAX_MAX_NNZ the plan's key says so: the default key
            # stays the reference's
            relax = {} if csr.nnz <= RELAX_MAX_NNZ else {"allow_relax": False}
            plan = cached_build(
                lambda: _cast_values(
                    build_sbell_plan(csr, dtype=dtype, **relax), values),
                csr, dtype, cache_dir, fmt="sbell", values=values, **relax,
            )
            span.set(fp32_plan=_sbell_streams(plan),
                     allow_relax=not relax)
            trace.count("tune.fp32_nnz", plan.nnz_full)
            trace.count("tune.fp32_far_nnz",
                        0 if plan.far is None else plan.far.nnz)
            dev = _upload(spmv_ops.sym_to_device, plan, device)
            tuned = TunedMatrix(
                fmt, csr.nrows, csr.ncols, plan.nnz_full, True, plan,
                dev, spmv_ops.sbell_apply, spmv_ops.sbell_apply_mm,
                plan.far_fraction, plan.padding_ratio, device,
            )
        else:
            from ..formats.bell2 import build_general_plan

            with trace.span("cfs.tune.expand"):
                gen_csr = (CSR.from_coo(csr.to_coo().expand_symmetric())
                           if csr.symmetric else csr)
            # aggressive tuning peels dense signed-offset diagonals into the
            # index-free SDIA stream; Tuning.NONE stays the plain one-sided
            # oracle path
            peel = tuning == Tuning.AGGRESSIVE
            plan = cached_build(
                lambda: _cast_values(
                    build_general_plan(gen_csr, dtype=dtype, dia=peel),
                    values),
                gen_csr, dtype, cache_dir, fmt="bell2", values=values,
                dia=peel,
            )
            dev = _upload(spmv_ops.to_device, plan, device)
            tuned = TunedMatrix(
                Format.CSR, gen_csr.nrows, gen_csr.ncols, gen_csr.nnz,
                csr.symmetric, plan, dev, spmv_ops.bell2_apply,
                spmv_ops.bell2_apply_mm, 0.0,
                plan.padding_ratio, device,
            )
        if perm is not None:
            with trace.span("cfs.tune.upload", what="permutation"):
                tuned = _permuted(tuned, perm)
        if bsr is not None:
            tuned = dataclasses.replace(tuned, format=Format.BSR, bsr=bsr)
        if tuned.spill_fraction > config.spill_warn_fraction:
            warn(
                "tune: %.0f%% of nonzeros fell to the one-sided far stream "
                "(scattered structure; consider reorder=True)",
                100 * tuned.spill_fraction,
            )
        info(
            "tune: fmt=%s nnz=%d pad=%.2fx far=%.4f reorder=%s values=%s "
            "device=%s", tuned.format, tuned.nnz_full, tuned.padding_ratio,
            tuned.spill_fraction, perm is not None, values, device,
        )
        return tuned


def _sbell_streams(plan) -> dict:
    """The streams a symmetric float32 plan holds, each with its stored
    entries (``sdia``, ``paired``, and the far stream as ``far_grouped``,
    degree-grouped and unpermuted, or ``far_entries``, the sparse
    residual), and the plan's ``padding_ratio``."""
    streams = {}
    if plan.dia is not None:
        streams["sdia"] = plan.dia.nnz
    if plan.nnz_paired:
        streams["paired"] = plan.nnz_paired
    if plan.far is not None:
        grouped = plan.far.row_perm is not None
        streams["far_grouped" if grouped else "far_entries"] = plan.far.nnz
    streams["padding_ratio"] = plan.padding_ratio
    return streams


def _cast_values(plan, values: str):
    """The port of the reference's ``_cast_values``: with ``"bfloat16"``,
    the stream value arrays (``plan.vals``, ``plan.far.vals``,
    ``plan.dia.vals``) rounded to bfloat16, to nearest even, and held as
    their bits (``ops/spmv.bf16_bits``); indices, metadata and ``diag``
    are untouched. ``"same"`` returns the plan as it is."""
    if values == "same":
        return plan
    if values != "bfloat16":
        raise ValueError(f"values must be 'same' or 'bfloat16', got {values}")
    plan.vals = spmv_ops.bf16_bits(plan.vals)
    if getattr(plan, "far", None) is not None:
        plan.far.vals = spmv_ops.bf16_bits(plan.far.vals)
    if getattr(plan, "dia", None) is not None:
        plan.dia.vals = spmv_ops.bf16_bits(plan.dia.vals)
    return plan


def _permuted(tuned: TunedMatrix, perm: np.ndarray) -> TunedMatrix:
    """Wrap the appliers with the P A Pᵀ input/output gathers (rows of x
    or X); the permutation tensors travel inside the operands."""
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    operands = {
        "dev": tuned.operands,
        "p": torch.as_tensor(perm, dtype=torch.int64, device=tuned.device),
        "ip": torch.as_tensor(iperm, dtype=torch.int64, device=tuned.device),
    }
    inner_mv, inner_mm = tuned._apply_mv, tuned._apply_mm

    def apply_mv(ops, x):
        y = inner_mv(ops["dev"], _rows(x, ops["p"]))
        return _rows(y, ops["ip"])

    def apply_mm(ops, x):
        y = inner_mm(ops["dev"], _rows(x, ops["p"]))
        return _rows(y, ops["ip"])

    return dataclasses.replace(
        tuned, operands=operands, _apply_mv=apply_mv, _apply_mm=apply_mm,
        perm=perm, _inner=(inner_mv, inner_mm, tuned.operands),
    )


def _rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The rows of x (or X) in the order ``perm``."""
    with trace.span("cfs.stage", op="permute") as s:
        return s.wrote(torch.index_select(x, 0, perm))


def _device_bytes(obj, seen=None) -> int:
    """Bytes of the tensors reachable from an uploaded plan (a tensor, a
    dict, a dataclass), each storage once."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        if st.data_ptr() in seen:
            return 0
        seen.add(st.data_ptr())
        return st.nbytes()
    if isinstance(obj, dict):
        return sum(_device_bytes(v, seen) for v in obj.values())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_device_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    return 0


def _upload(to_device, plan, device):
    """``to_device(plan, device)`` as the span ``cfs.tune.upload``. While
    recording, the span ends once the copies have finished, and their
    bytes count as ``upload.bytes``."""
    with trace.span("cfs.tune.upload") as s:
        dev = to_device(plan, device)
        if trace.is_recording():
            nbytes = _device_bytes(dev)
            s.set(bytes=nbytes)
            trace.count("upload.bytes", nbytes)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return dev


def build_fp64_plan(csr: CSR, entries: bool = False):
    """The float64 plan of ``csr``: the decisions of the reference's
    ``_tune_fp64_df._build``, with float64 values in place of its fp32
    (hi, lo) pairs (a rejoined pair keeps about 48 bits of the 53).
    With ``entries``, a symmetric square matrix peels alike and, where the
    peel took diagonals, keeps what is left of its lower triangle as it
    is, for the upload to expand (``ops/fp64_entries.Fp64EntriesPlan``):
    no slot-packed stream. A matrix the peel takes nothing of keeps the
    grid, whose degree-grouped one-sided stream writes each row once.

    A symmetric square matrix peels its dense lower diagonals, the main
    one included, into an SDIA plan (``plan.dia``) whose main diagonal is
    halved (exact: a factor of 0.5 changes the exponent only), so that
    the symmetric kernel's row side and transpose side each add half of
    it; what the peel leaves is expanded to both triangles. Everything
    else is expanded whole. The entries go into one slot-packed one-sided
    stream.

    The peel has no row ceiling, where the reference's stops at half its
    ``SDIA_SYM_ROWS_MAX`` (the TPU kernel holds x and y whole in its fast
    memory): the CUDA kernel reads both from global memory at any height.
    Under that ceiling the two planners decide alike."""
    from ..formats import sdia
    from ..formats.bell2 import build_bell2_from_arrays

    nrows = csr.nrows
    if csr.symmetric and nrows == csr.ncols:
        lcoo = csr.to_coo()  # lower triangle incl. diagonal
        row_l = np.asarray(lcoo.row)
        col_l = np.asarray(lcoo.col)
        val_l = np.asarray(lcoo.val, np.float64)
        dia, resid = sdia.extract_sdia(
            row_l, col_l, val_l, nrows, dtype=np.float64,
            include_zero=True, min_frac=0.25,
        )
        if dia is not None and 0 in dia.offsets:
            dia.vals[:, dia.offsets.index(0)] *= 0.5
        if entries and dia is not None:
            return Fp64EntriesPlan.from_lower(
                nrows, row_l[resid], col_l[resid], val_l[resid], dia)
        if dia is not None:
            rr, cc, vv = row_l[resid], col_l[resid], val_l[resid]
            strict = rr != cc
            plan = build_bell2_from_arrays(
                nrows, nrows,
                np.concatenate([rr, cc[strict]]).astype(np.int32),
                np.concatenate([cc, rr[strict]]).astype(np.int32),
                np.concatenate([vv, vv[strict]]), dtype=np.float64,
                force_slot=True,
            )
            plan.dia = dia
            return plan
    coo = csr.to_coo().expand_symmetric() if csr.symmetric else csr.to_coo()
    return build_bell2_from_arrays(
        coo.nrows, coo.ncols,
        np.asarray(coo.row, np.int32), np.asarray(coo.col, np.int32),
        np.asarray(coo.val, np.float64), dtype=np.float64, force_slot=True,
    )


def _diagonal_entries(csr: CSR, rows_per_pass: int = 1 << 16) -> int:
    """The stored entries of the square ``csr`` on its main diagonal, in
    any column order, duplicates each counted. A pass takes
    ``rows_per_pass`` rows, so that the row index of each entry exists
    for those rows only, in the type of the column indices."""
    indptr, indices = np.asarray(csr.indptr), np.asarray(csr.indices)
    ndiag = 0
    for r0 in range(0, csr.nrows, rows_per_pass):
        r1 = min(r0 + rows_per_pass, csr.nrows)
        rows = np.repeat(np.arange(r0, r1, dtype=indices.dtype),
                         np.diff(indptr[r0:r1 + 1]))
        ndiag += int(np.count_nonzero(indices[indptr[r0]:indptr[r1]] == rows))
    return ndiag


def _tune_fp64(csr: CSR, fmt: Format, device,
               cache_dir: str | None = None) -> TunedMatrix:
    """float64 through the native fp64 kernels (the port of the
    reference's ``_tune_fp64_df``): no reordering, no BSR container, and
    every plan runs the kernels (the CUDA kernels read listed windows
    too, so there is no fallback for plans that are not word-eligible).
    An empty matrix gets an applier of zeros. The plan is cached as
    ``fmt="bell2_f64"``: it holds float64 values, where the reference's
    ``"bell2_df"`` plan of the same matrix holds fp32 (hi, lo) pairs, so
    the two must never share a key. ``sdia_rows="any"`` keys the planner
    without a row ceiling apart from the plans of one that expanded every
    matrix past 5M rows; ``fp64_stream="entries"`` keys the plan of a
    symmetric matrix past ``FP64_ENTRIES_MIN_NNZ`` stored entries (an
    entry list where the peel takes diagonals) apart from the grid's."""
    entries = (csr.symmetric and csr.nrows == csr.ncols
               and csr.nnz > FP64_ENTRIES_MIN_NNZ)
    key = {"fp64_stream": "entries"} if entries else {}
    plan = cached_build(lambda: build_fp64_plan(csr, entries=entries), csr,
                        np.float64, cache_dir, fmt="bell2_f64",
                        sdia_rows="any", **key)
    dev = _upload(spmv_ops.fp64_to_device, plan, device)
    nnz_full = plan.nnz
    if isinstance(plan, Fp64EntriesPlan) or (csr.symmetric
                                             and plan.dia is not None):
        with trace.span("cfs.tune.diag_count"):
            ndiag = _diagonal_entries(csr)
        nnz_full = 2 * csr.nnz - ndiag
    tuned = TunedMatrix(
        fmt, csr.nrows, csr.ncols, nnz_full, csr.symmetric, plan, dev,
        spmv_ops.fp64_apply, spmv_ops.fp64_apply_mm, 0.0,
        plan.padding_ratio, device, dtype=torch.float64,
    )
    info(
        "tune: fp64 -> native fp64 kernels, nnz=%d stream=%s "
        "(%d entries, %d slots) pad=%.2fx sdia=%s device=%s",
        nnz_full, *_fp64_stream(tuned), plan.padding_ratio,
        0 if plan.dia is None else len(plan.dia.offsets), device,
    )
    return tuned


def _fp64_stream(tuned: TunedMatrix) -> tuple[str, int, int]:
    """The one-sided stream of a float64 plan as uploaded: its form
    (``"entries"``, ``"grouped"``, ``"grid"`` or ``"none"``), its stored
    entries (both triangles, stored zeros included, as the plan holds
    them: the same count in either plan form of one matrix) and the slots
    of the chunk grid the host plan holds (0 for an entry-list plan)."""
    plan, dev = tuned.plan, tuned.operands
    slots = (plan.num_chunks * SUBLANES * LANES
             if isinstance(plan, Bell2Plan) else 0)
    if dev.entries is not None:
        form = "entries"
    elif not dev.has_work:
        return "none", 0, slots
    else:
        form = "grouped" if dev.grouped else "grid"
    return form, plan.nnz, slots


@dataclasses.dataclass
class CooDevicePlan:
    """Tensors backing the plain float64 ELL+COO path (``row is None``
    when the slab holds every entry)."""

    row: object
    col: object
    val: object
    ecol: object = None
    evals: object = None

    def stream_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row, self.col, self.val, self.ecol,
                             self.evals) if t is not None)


def _tune_fp64_xla(csr: CSR, fmt: Format, device) -> TunedMatrix:
    """float64 through the plain-PyTorch ELL slab + COO remainder
    (``ops/xla_ref.py``), the port of the reference's ``_tune_fp64_xla``;
    selected only by ``CFS_FP64=xla``."""
    from ..ops import xla_ref

    with trace.span("cfs.tune.plan_build"):
        coo = (csr.to_coo().expand_symmetric() if csr.symmetric
               else csr.to_coo())
        ecol, evals, rrow, rcol, rval = xla_ref.build_ell_hyb(
            coo.row, coo.col, coo.val.astype(np.float64), csr.nrows
        )
    nrows = csr.nrows
    has_rem = len(rrow) > 0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    def upload(plan, device):
        return {
            "ecol": t(ecol),
            "evals": t(evals),
            "row": t(rrow.astype(np.int32)) if has_rem else None,
            "col": t(rcol.astype(np.int32)) if has_rem else None,
            "val": t(rval) if has_rem else None,
        }

    ops = _upload(upload, None, device)

    def apply_mv(ops, x):
        y = xla_ref.ell_spmv(ops["ecol"], ops["evals"], x)
        if ops["row"] is not None:
            y = y + xla_ref.coo_spmv(ops["row"], ops["col"], ops["val"], x,
                                     nrows=nrows)
        return y

    def apply_mm(ops, x):
        y = xla_ref.ell_spmm(ops["ecol"], ops["evals"], x)
        if ops["row"] is not None:
            y = y + xla_ref.coo_spmm(ops["row"], ops["col"], ops["val"], x,
                                     nrows=nrows)
        return y

    info(
        "tune: fp64 -> plain ELL(%d)+COO path, nnz=%d (rem %d) device=%s",
        ecol.shape[1], coo.nnz, len(rrow), device,
    )
    return TunedMatrix(
        fmt, nrows, csr.ncols, coo.nnz, csr.symmetric,
        CooDevicePlan(ops["row"], ops["col"], ops["val"], ops["ecol"],
                      ops["evals"]),
        ops, apply_mv, apply_mm, 0.0,
        float(ecol.size + len(rrow)) / max(coo.nnz, 1), device,
        dtype=torch.float64,
    )
