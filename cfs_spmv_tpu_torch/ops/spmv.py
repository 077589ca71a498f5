"""Op-level SpMV and SpMM: plan → device tensors → padded kernel calls.

Port of ``cfs_spmv_tpu/ops/spmv.py``: it owns padding/unpadding
and the composition of streams — for the symmetric path the paired
stream or the diagonal seed, the degree-grouped or sparse far residual
and the dense-diagonal SDIA stream (``sbell_apply``); for the general
path one one-sided stream and the signed-offset SDIA stream
(``bell2_apply``); and the same two compositions for B right-hand sides
(``sbell_apply_mm``, ``bell2_apply_mm``), whose X and Y travel as (B,
rows, 128) planes. The float64 route (``Fp64Device``, ``fp64_apply``,
``fp64_apply_mm``) composes the one-sided stream (or, for a peel residual
or sparse stream, its entry list) and the symmetric diagonal stream in
IEEE double, as the appliers inside the reference's
``tuning/tune._tune_fp64_df`` do with double-float pairs; a plan that is
diagonals only multiplies an (n, B) X where it lies, into a fresh (n, B)
Y, with no planes (``sdia_df.sdia_sym_rows_df_mm``). The float32
appliers also take float64 structs with a float64 x (the float64
``DistSpDMV``'s shards, as the reference runs its distributed program on
float64 arrays): the one-sided stream, its entries and the symmetric
diagonals then run their double wrappers (``bell2_df``, ``sdia_df``), and
the paired stream and the signed diagonals the double instances of their
own wrappers. Only a degree-grouped stream has no float64 form there (the
unpermute, B3/B9, is float only; no shard plan is grouped). The device
structs are plain dataclasses of tensors on one explicit device.

bfloat16 values (``values="bfloat16"``): numpy has no bfloat16 type
without ``ml_dtypes``, which the port does not import, so a host plan
holds such a value array as its uint16 bits (``io/plancache.BF16_BITS``,
:func:`bf16_bits`), 2 bytes a value as in the reference's plan. The
uploads view those bits as ``torch.bfloat16`` tensors (the paired and
one-sided chunk grids, the diagonal planes, an entry list's values), and
the appliers pass them to the kernel wrappers as they are; ``diag``, x,
y and every sum stay float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.bell2 import LANES, SUBLANES
from ..io.plancache import BF16_BITS
from ..utils import trace
from . import bell2_df as bdf
from . import bell2_kernel as bk
from . import sdia_df as sdf
from . import sdia_kernel as sk

__all__ = [
    "BF16_BITS",
    "bf16_bits",
    "bf16_widen",
    "Bell2Device",
    "SBellDevice",
    "Fp64Device",
    "as_device",
    "to_device",
    "sym_to_device",
    "fp64_to_device",
    "pad_x",
    "pad_x_mm",
    "bell2_apply",
    "bell2_apply_mm",
    "sbell_apply",
    "sbell_apply_mm",
    "fp64_apply",
    "fp64_apply_mm",
]


def as_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without CUDA raises
    here, before any planning work (the port never falls back to CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class Bell2Device:
    """Device-resident one-sided BELL2 stream: the general path's matrix
    (with its optional signed-offset SDIA stream) or the symmetric far
    stream."""

    #: the chunk grid; None for an accumulating stream, which travels as
    #: ``entries`` instead
    vals: torch.Tensor | None  # (C*8, 128) float32
    packed: torch.Tensor | None  # (C*8, 128) int16, q | r2 << 7
    meta: torch.Tensor | None  # (C, 10) int32
    step_block: torch.Tensor | None  # (C/K,) int32
    num_row_tiles: int
    x_rows: int
    nrows: int
    ncols: int
    chunks_per_step: int
    tiles_per_block: int
    #: x row is ``meta[c, 2] + r2`` (contiguous or deep windows), else
    #: ``meta[c, 2 + (r2 & 7)]`` (listed windows)
    contig: bool
    #: accumulating stream (a post-peel residual): added into given tiles,
    #: rows without entries never touched
    sparse_stream: bool
    #: False for an empty (or dia-only) stream: no kernel runs
    has_work: bool
    #: degree-grouped row tiling (``formats/bell2.Bell2Plan.row_perm``):
    #: the compact output is unpermuted by ``unperm_gather_tiles``
    unperm_pk: torch.Tensor | None = None  # (nb*8, 128) int32
    unperm_slabs: torch.Tensor | None = None  # (nb, W) int32
    #: signed-offset dense-diagonal stream of a general plan
    dia_vals: torch.Tensor | None = None  # (R, D, 8, 128) float32
    dia_offsets: torch.Tensor | None = None  # (D,) int32
    #: the live entries of an ungrouped sparse stream with work, compacted
    #: from the chunk grid at upload (``bell2_kernel.compact_stream``)
    entries: bk.EntryStream | None = None
    #: the chunk grid visits every block of its output: the kernel zeroes
    #: the whole output in one pass
    covers: bool = False

    @property
    def grouped(self) -> bool:
        return self.unperm_pk is not None

    def stream_kw(self) -> dict:
        """The geometry arguments of this stream's kernel wrappers."""
        return dict(num_row_tiles=self.num_row_tiles,
                    chunks_per_step=self.chunks_per_step,
                    tiles_per_block=self.tiles_per_block,
                    contig=self.contig)


@dataclasses.dataclass
class SBellDevice:
    """Device-resident symmetric plan: the paired stream (or the diagonal
    seed), the far residual and the SDIA stream."""

    diag: torch.Tensor  # (nrows,) float32
    far: Bell2Device | None
    num_row_tiles: int
    x_rows: int
    nrows: int
    chunks_per_step: int
    tiles_per_block: int
    transpose_windows: int = 2
    #: the paired stream, uploaded only when it holds entries
    vals: torch.Tensor | None = None  # (C*8, 128) float32
    packed: torch.Tensor | None = None  # (C*8, 128) int32
    meta: torch.Tensor | None = None  # (C, 10) int32
    step_block: torch.Tensor | None = None  # (C/K,) int32
    dia_vals: torch.Tensor | None = None  # (R, D, 8, 128) float32
    #: (D,) int32: all >= 1 (the main diagonal travels in ``diag``), or
    #: mirrored (signed) past SDIA_SYM_ROWS_MAX
    dia_offsets: torch.Tensor | None = None
    dia_mirrored: bool = False
    #: over planes the symmetric diagonal kernel stages x near each CTA's
    #: rows (``sdia_kernel.stages_x`` of the offsets)
    dia_stage_x: bool = False
    #: mirrored offsets that span little: (hi, span), the x window the
    #: double signed diagonal kernel stages (``sdia_kernel.gen_window``);
    #: float32 and bf16 values run as they are
    dia_window: tuple[int, int] | None = None
    #: row pointers over the far stream's entries and their slices, where
    #: those float32 entries are the plan's whole off-diagonal part (no
    #: paired stream, no diagonal stream): ``sbell_apply`` then writes y
    #: = D x + R x in one pass (``bell2_kernel.bell2_entries_rows``)
    far_rows: bk.EntryRows | None = None

    @property
    def has_paired(self) -> bool:
        return self.vals is not None


@dataclasses.dataclass
class Fp64Device:
    """Device-resident float64 plan: the one-sided BELL2 stream in double
    (the whole matrix, or what the diagonal peel left) and, for a
    symmetric matrix, the dense lower diagonals with the main one stored
    halved. An ungrouped peel residual or sparse stream travels as its
    live ``entries``, without the chunk grid."""

    nrows: int
    ncols: int
    num_row_tiles: int
    x_rows: int
    chunks_per_step: int
    tiles_per_block: int
    contig: bool
    #: False for an empty or dia-only stream: the stream kernel never runs
    has_work: bool
    #: the chunk grid; None where the stream travels as ``entries``
    vals: torch.Tensor | None = None  # (C*8, 128) float64
    packed: torch.Tensor | None = None  # (C*8, 128) int16, q | r2 << 7
    meta: torch.Tensor | None = None  # (C, 10) int32
    step_block: torch.Tensor | None = None  # (C/K,) int32
    #: degree-grouped plan: flat slot of each original row in the stream's
    #: output, padded to whole tiles of rows; rows without entries (and the
    #: padding) point one past the output, at a zero appended to it
    row_perm: torch.Tensor | None = None  # (ceil(nrows/128)*128,) int64
    dia_vals: torch.Tensor | None = None  # (R, D, 8, 128) float64
    dia_offsets: torch.Tensor | None = None  # (D,) int32, each >= 0
    #: as ``SBellDevice.dia_stage_x``
    dia_stage_x: bool = False
    #: the live entries of an ungrouped peel residual or sparse stream,
    #: compacted from the chunk grid at upload
    entries: bk.EntryStream | None = None
    #: the chunk grid visits every block of its output: the kernel zeroes
    #: the whole output in one pass
    covers: bool = False

    @property
    def grouped(self) -> bool:
        return self.row_perm is not None

    def stream_kw(self) -> dict:
        """The geometry arguments of the chunk grid's kernel wrappers."""
        return dict(num_row_tiles=self.num_row_tiles,
                    chunks_per_step=self.chunks_per_step,
                    tiles_per_block=self.tiles_per_block,
                    contig=self.contig)


def _tensor(a, device):
    """A plan's array on ``device``, in its own type; bfloat16 bits
    (``BF16_BITS``) as a ``torch.bfloat16`` tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a).to(device)


def bf16_bits(a) -> np.ndarray:
    """The bits of ``a`` (float32) rounded to bfloat16, to nearest even,
    as ``astype(jnp.bfloat16)`` rounds: a ``BF16_BITS`` array of ``a``'s
    shape."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16_BITS)


def bf16_widen(bits) -> np.ndarray:
    """The float32 values of bfloat16 ``bits`` (exact: a bfloat16 is the
    upper half of a float32)."""
    wide = np.asarray(bits, BF16_BITS).astype(np.uint32) << 16
    return wide.view(np.float32)


def _check_chunks(meta, step_block, K, BT):
    """Checks shared by the one-sided and the paired streams."""
    C = meta.shape[0]
    if C % K or len(step_block) != C // K:
        raise ValueError("stream not padded to whole K-chunk steps")
    if C and (meta[:, 0].max() >= BT or meta[:, 0].min() < 0):
        raise ValueError("meta sub row outside its output block")


def _check_stream_plan(plan, contig):
    """Host-side index checks of a one-sided stream, once per upload: the
    kernels trust these ranges and read without bounds checks."""
    meta = np.asarray(plan.meta)
    C = meta.shape[0]
    if plan.lane_rot != 1 or plan.max_windows != SUBLANES:
        raise NotImplementedError(
            "lane rotation and capped window stacks were pruned from the "
            "reference planner; the port takes rot=1, 8-window plans only"
        )
    _check_chunks(meta, plan.step_block, plan.chunks_per_step,
                  plan.tiles_per_block)
    if C:
        hi = (meta[:, 2] + plan.window_depth - 1) if contig else meta[:, 2:]
        if int(np.max(hi)) >= plan.x_rows or int(meta[:, 2:].min()) < 0:
            raise ValueError("meta window outside the x operand")
    run = plan.run_len
    if run > 1:
        # the reference applies meta[k0, 0] to a whole run; the kernels
        # use each chunk's own sub, which is the same only when every run
        # shares one sub (the planner pads tiles to run multiples)
        if C % run or np.any(meta[:, 0].reshape(-1, run)
                             != meta[::run, 0][:, None]):
            raise ValueError("a chunk run spans two sub rows")


def _visits_every_block(step_block, num_row_tiles, BT) -> bool:
    """Whether a stream's steps visit every output block of its
    ceil(T/BT)-block output."""
    return np.array_equal(np.unique(np.asarray(step_block)),
                          np.arange(-(-num_row_tiles // BT)))


def _check_paired_plan(plan):
    """Host-side index checks of a paired stream (``sbell_spmv_tiles``
    reads and scatters without bounds checks)."""
    meta = np.asarray(plan.meta)
    sb = np.asarray(plan.step_block).astype(np.int64)
    K, BT, TW = plan.chunks_per_step, plan.tiles_per_block, plan.transpose_windows
    if TW not in (2, 4):
        raise ValueError(f"transpose_windows must be 2 or 4, got {TW}")
    _check_chunks(meta, sb, K, BT)
    if not _visits_every_block(sb, plan.num_row_tiles, BT):
        raise ValueError("the paired stream must visit every output block")
    blk = np.repeat(sb, K)
    if np.any(blk * BT + meta[:, 0] >= plan.x_rows):
        raise ValueError("a chunk's row tile lies outside the x operand")
    win = meta[:, 2:2 + TW].astype(np.int64)
    if np.any(win // BT != blk[:, None]) or win.max() >= plan.x_rows:
        raise ValueError("a transpose window outside its chunk's block")


def _dia_fields(dia, device):
    if dia is None:
        return dict(dia_vals=None, dia_offsets=None)
    return dict(
        dia_vals=_tensor(dia.vals, device),
        dia_offsets=torch.tensor([int(d) for d in dia.offsets],
                                 dtype=torch.int32, device=device),
    )


def to_device(plan, device) -> Bell2Device:
    """Upload a one-sided ``Bell2Plan`` (the port's or the reference's:
    the fields and dtypes are the same), with its signed-offset SDIA
    stream if it has one, to ``device``. An ungrouped sparse stream (an
    accumulating residual, nearly all padding in the chunk grid) is
    uploaded as its live entries only; grouped and covering streams as
    their chunk grid, with ``covers`` recording whether it visits every
    output block (then the kernel zeroes whole planes). bfloat16 values
    (``BF16_BITS``) upload as ``torch.bfloat16``; an entry list is
    compacted from their exact float32 widening and its values cast back
    (exact), so a freshly cast plan and the same plan loaded from a plan
    cache give one list."""
    device = as_device(device)
    if plan.row_perm is not None and plan.unperm_pk is None:
        raise NotImplementedError(
            "legacy grouped plans without an unpermute table are not "
            "ported (ROADMAP: do not port)"
        )
    contig = plan.windows_contig or plan.window_depth > SUBLANES
    _check_stream_plan(plan, contig)
    if plan.unperm_pk is not None:
        slabs = np.asarray(plan.unperm_slabs)
        pk = np.asarray(plan.unperm_pk)
        if slabs.size and (slabs.max() >= plan.num_row_tiles
                           or slabs.min() < 0):
            raise ValueError("unperm slab row outside the grouped tiles")
        if pk.size and (pk >> 7).max() >= slabs.shape[1]:
            raise ValueError("unperm window index past the slab list")
    t = lambda a: None if a is None else _tensor(a, device)  # noqa: E731
    grid = {k: getattr(plan, k)
            for k in ("vals", "packed", "meta", "step_block")}
    entries, covers = None, False
    if plan.sparse_stream and plan.row_perm is None and plan.nnz > 0:
        vals = np.asarray(plan.vals)
        bf16 = vals.dtype == BF16_BITS
        entries = bk.compact_stream(
            bf16_widen(vals) if bf16 else vals, plan.packed, plan.meta,
            plan.step_block, chunks_per_step=plan.chunks_per_step,
            tiles_per_block=plan.tiles_per_block, contig=contig,
            num_row_tiles=plan.num_row_tiles, x_rows=plan.x_rows,
            device=device,
        ).to(device, torch.bfloat16 if bf16 else None)
        grid = dict.fromkeys(grid)
    elif plan.nnz > 0:
        covers = _visits_every_block(plan.step_block, plan.num_row_tiles,
                                     plan.tiles_per_block)
    return Bell2Device(
        **{k: t(a) for k, a in grid.items()},
        entries=entries,
        covers=covers,
        num_row_tiles=plan.num_row_tiles,
        x_rows=plan.x_rows,
        nrows=plan.nrows,
        ncols=plan.ncols,
        chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block,
        contig=contig,
        sparse_stream=plan.sparse_stream,
        has_work=plan.nnz > 0,
        unperm_pk=t(plan.unperm_pk),
        unperm_slabs=t(plan.unperm_slabs),
        **_dia_fields(plan.dia, device),
    )


def sym_to_device(plan, device) -> SBellDevice:
    """Upload a symmetric ``SBellPlan`` (the port's or the reference's) to
    ``device``. The paired stream's arrays are uploaded only when it holds
    entries, as in the reference."""
    device = as_device(device)
    far = None
    if plan.far is not None:
        if plan.far.x_rows > plan.x_rows:
            raise ValueError("far stream windows exceed the shared x")
        far = to_device(plan.far, device)
        if (far.entries is not None
                and far.entries.min_tiles > plan.num_row_tiles):
            raise ValueError("far stream rows exceed the plan's tiles")
    paired = {}
    if plan.nnz_paired:
        _check_paired_plan(plan)
        paired = {k: _tensor(getattr(plan, k), device)
                  for k in ("vals", "packed", "meta", "step_block")}
    far_rows = None
    if (far is not None and far.entries is not None and not paired
            and plan.dia is None and far.entries.vals.dtype == torch.float32):
        far_rows = bk.entry_rows(far.entries, plan.nrows)
    offsets = () if plan.dia is None else tuple(plan.dia.offsets)
    return SBellDevice(
        diag=_tensor(plan.diag, device),
        far=far,
        num_row_tiles=plan.num_row_tiles,
        x_rows=plan.x_rows,
        nrows=plan.nrows,
        chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block,
        transpose_windows=plan.transpose_windows,
        dia_mirrored=any(d < 0 for d in offsets),
        dia_stage_x=sk.stages_x(offsets),
        dia_window=(sk.gen_window(offsets) if any(d < 0 for d in offsets)
                    else None),
        far_rows=far_rows,
        **paired,
        **_dia_fields(plan.dia, device),
    )


def fp64_to_device(plan, device) -> Fp64Device:
    """Upload a float64 plan: a one-sided ``Bell2Plan`` whose ``dia`` (if
    any) holds lower diagonals with offsets ``>= 0`` and the main one
    halved, as ``tuning/tune._tune_fp64`` builds it with float64 values.
    The reference's double-float plan of the same matrix (float32 ``vals``
    with the low halves in ``vals2``) is accepted too: its two planes are
    rejoined in float64.

    An ungrouped stream that is a peel's residual or sparse (built
    without covering chunks) is uploaded as its live entries only
    (``bell2_kernel.compact_stream`` of the unchanged plan): the appliers
    add them into zero tiles. Grouped streams and a whole-matrix stream
    keep the chunk grid; a grouped one may be sparse, its rows are
    gathered. ``covers`` records whether the grid visits every block."""
    device = as_device(device)
    contig = plan.windows_contig or plan.window_depth > SUBLANES
    _check_stream_plan(plan, contig)
    has_work = plan.nnz > 0
    T = plan.num_row_tiles
    stream = {}
    accumulates = plan.row_perm is None and (plan.dia is not None
                                             or plan.sparse_stream)
    if has_work:
        vals = np.asarray(plan.vals, np.float64)
        if plan.vals2 is not None:
            vals = vals + np.asarray(plan.vals2, np.float64)
        grid = dict(vals=vals, packed=plan.packed, meta=plan.meta,
                    step_block=plan.step_block)
    if has_work and accumulates:
        stream["entries"] = bk.compact_stream(
            **grid, chunks_per_step=plan.chunks_per_step,
            tiles_per_block=plan.tiles_per_block, contig=contig,
            num_row_tiles=T, x_rows=plan.x_rows, device=device,
        )
    elif has_work:
        stream = {k: _tensor(a, device) for k, a in grid.items()}
        stream["covers"] = _visits_every_block(
            plan.step_block, T, plan.tiles_per_block)
        if plan.row_perm is not None:
            perm = np.asarray(plan.row_perm, np.int64)
            if perm.size and (perm.min() < 0 or perm.max() > T * LANES):
                raise ValueError("row_perm slot outside the stream's output")
            pad = -(-plan.nrows // LANES) * LANES - plan.nrows
            stream["row_perm"] = _tensor(
                np.concatenate([perm, np.full(pad, T * LANES, np.int64)]),
                device)
    dia = {}
    if plan.dia is not None:
        if min(plan.dia.offsets) < 0:
            raise ValueError("the float64 diagonal stream takes lower "
                             "diagonals (offsets >= 0) only")
        dia = _dia_fields(plan.dia, device)
        dia["dia_vals"] = dia["dia_vals"].to(torch.float64)
        dia["dia_stage_x"] = sk.stages_x(plan.dia.offsets)
    return Fp64Device(
        nrows=plan.nrows, ncols=plan.ncols, num_row_tiles=T,
        x_rows=plan.x_rows, chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block, contig=contig,
        has_work=has_work, **stream, **dia,
    )


def pad_x(x: torch.Tensor, x_rows: int) -> torch.Tensor:
    """(m,) → (x_rows, 128) zero-padded segment-sliceable layout."""
    m = x.shape[0]
    with trace.span("cfs.stage", op="pad_x") as s:
        return s.wrote(torch.nn.functional.pad(
            x, (0, x_rows * LANES - m)).reshape(x_rows, LANES))


def pad_x_mm(x: torch.Tensor, x_rows: int) -> torch.Tensor:
    """(m, B) → contiguous (B, x_rows, 128) zero-padded planes: one
    padded copy of Xᵀ (``pad`` would keep Xᵀ's transposed strides)."""
    m, B = x.shape
    with trace.span("cfs.stage", op="pad_x_mm") as s:
        x3d = s.wrote(x.new_zeros((B, x_rows, LANES)))
        x3d.view(B, -1)[:, :m] = x.T
    return x3d


def _zeros(like: torch.Tensor, shape) -> torch.Tensor:
    """Zero tiles of ``like``'s type and device: the start of an
    accumulating stream's output."""
    with trace.span("cfs.stage", op="zeros") as s:
        return s.wrote(like.new_zeros(shape))


def _gather_rows(tiles: torch.Tensor, row_perm: torch.Tensor,
                 B: int | None = None) -> torch.Tensor:
    """A degree-grouped stream's output rows in their order: each (B
    planes of) ``tiles`` flattened, a zero appended, gathered by
    ``row_perm`` (its last slot names the zero)."""
    with trace.span("cfs.stage", op="gather_rows") as s:
        if B is None:
            flat = s.wrote(torch.cat([tiles.reshape(-1), tiles.new_zeros(1)]))
            return s.wrote(torch.index_select(flat, 0, row_perm))
        flat = s.wrote(torch.cat([tiles.reshape(B, -1),
                                  tiles.new_zeros((B, 1))], dim=1))
        return s.wrote(torch.index_select(flat, 1, row_perm))


def _diag_term(diag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """D x (a 2-D X: D applied to each column)."""
    with trace.span("cfs.stage", op="diag") as s:
        return s.wrote(diag * x if x.ndim == 1 else diag[:, None] * x)


def _plus_diag(y: torch.Tensor, diag: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y + D x."""
    with trace.span("cfs.stage", op="plus_diag") as s:
        return s.wrote(y + (diag * x if x.ndim == 1 else diag[:, None] * x))


def _unperm_tiles(dev: Bell2Device, g_tiles, unperm=bk.unperm_gather_tiles,
                  **fused):
    """Original-row-order tiles (>= ceil(nrows/128) rows of 128) from a
    grouped stream's compact output tiles; absent rows read exact 0.
    ``fused``: the gather's ``seed`` or ``into`` form."""
    return unperm(dev.unperm_pk, dev.unperm_slabs,
                  g_tiles[: dev.num_row_tiles], **fused)


def _unperm_tiles_mm(dev: Bell2Device, g_tiles,
                     unperm=bk.unperm_gather_tiles_mm, **fused):
    """(B, >= ceil(nrows/128), 128) unpermuted tiles, multi-RHS."""
    return unperm(dev.unperm_pk, dev.unperm_slabs,
                  g_tiles[:, : dev.num_row_tiles], **fused)


#: the stream functions by role: name -> (kernel wrapper, plain twin)
_STREAMS = {
    "bell2": (bk.bell2_spmv_tiles, bk.bell2_spmv_tiles_plain),
    "bell2_acc": (bk.bell2_spmv_tiles_accum, bk.bell2_spmv_tiles_accum_plain),
    "bell2_rows": (bk.bell2_entries_rows, bk.bell2_entries_rows_plain),
    "unperm": (bk.unperm_gather_tiles, bk.unperm_gather_tiles_plain),
    "sbell": (bk.sbell_spmv_tiles, bk.sbell_spmv_tiles_plain),
    "sdia_sym": (sk.sdia_sym_tiles, sk.sdia_sym_tiles_plain),
    "sdia_gen": (sk.sdia_gen_tiles, sk.sdia_gen_tiles_plain),
    "bell2_mm": (bk.bell2_spmm_tiles, bk.bell2_spmm_tiles_plain),
    "bell2_acc_mm": (bk.bell2_spmm_tiles_accum,
                     bk.bell2_spmm_tiles_accum_plain),
    "unperm_mm": (bk.unperm_gather_tiles_mm, bk.unperm_gather_tiles_mm_plain),
    "sbell_mm": (bk.sbell_spmm_tiles, bk.sbell_spmm_tiles_plain),
    "sdia_sym_mm": (sk.sdia_sym_tiles_mm, sk.sdia_sym_tiles_mm_plain),
    "sdia_gen_mm": (sk.sdia_gen_tiles_mm, sk.sdia_gen_tiles_mm_plain),
    # the float64 route: the double kernels beside the same twins
    "bell2_df": (bdf.bell2_spmv_tiles_df, bk.bell2_spmv_tiles_plain),
    "bell2_df_mm": (bdf.bell2_spmm_tiles_df, bk.bell2_spmm_tiles_plain),
    "bell2_acc_df": (bdf.bell2_spmv_tiles_accum_df,
                     bk.bell2_spmv_tiles_accum_plain),
    "bell2_acc_df_mm": (bdf.bell2_spmm_tiles_accum_df,
                        bk.bell2_spmm_tiles_accum_plain),
    "sdia_df": (sdf.sdia_sym_tiles_df, sk.sdia_sym_tiles_plain),
    "sdia_df_mm": (sdf.sdia_sym_tiles_df_mm, sk.sdia_sym_tiles_mm_plain),
    "sdia_rows_df_mm": (sdf.sdia_sym_rows_df_mm, sdf.sdia_sym_rows_plain),
}


#: the roles whose float64 form is a wrapper of its own (``bell2_df``,
#: ``sdia_df``): what the float32 appliers run on float64 operands
_F64_ROLES = {"bell2": "bell2_df", "bell2_mm": "bell2_df_mm",
              "bell2_acc": "bell2_acc_df", "bell2_acc_mm": "bell2_acc_df_mm",
              "sdia_sym": "sdia_df", "sdia_sym_mm": "sdia_df_mm"}


def _kernels(plain: bool, dtype=torch.float32) -> dict:
    """The stream functions for x of ``dtype``: the CUDA kernel wrappers,
    or (``plain``) their plain PyTorch twins on whatever device the
    tensors live on — the baseline the kernels are timed and checked
    against. For float64, the roles of ``_F64_ROLES`` take their double
    wrappers."""
    roles = {k: fns[plain] for k, fns in _STREAMS.items()}
    if dtype == torch.float64:
        roles.update({k: roles[v] for k, v in _F64_ROLES.items()})
    return roles


def _check_vector(x, mm: str):
    if x.ndim != 1:
        raise ValueError(
            f"x must be 1-D, got shape {tuple(x.shape)}; a 2-D X (SpMM) "
            f"goes to {mm}"
        )


def _check_matrix(x) -> int:
    """The right-hand-side count B of a 2-D X (ncols, B), B >= 1."""
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D (ncols, B), got shape "
                         f"{tuple(x.shape)}")
    if x.shape[1] < 1:
        raise ValueError("X has no columns (B = 0)")
    return x.shape[1]


def bell2_apply(dev: Bell2Device, x: torch.Tensor, *, plain: bool = False):
    """General y = A x for one BELL2 stream plus its signed-offset SDIA
    stream, composed as the reference's ``bell2_apply``: an empty plan
    gives zero tiles, and a dia-only one has ``sdia_gen_tiles`` write its
    tiles from x itself (the store form, for the reference's zero tiles
    plus the add, and no padded copy of x); a
    sparse residual accumulates its entries into zero tiles; otherwise
    the full stream runs, unpermuted when grouped; then
    ``sdia_gen_tiles`` adds the diagonals. Rectangular matrices take the
    same code (no dia stream). ``plain=True`` runs every stream through
    its plain twin.
    """
    _check_vector(x, "bell2_apply_mm")
    f = _kernels(plain, x.dtype)
    # the stream reads x padded to its tiles; the diagonals alone read x
    if dev.has_work:
        x2d = pad_x(x, dev.x_rows)
    else:
        with trace.span("cfs.stage", op="contiguous") as s:
            x2d = s.wrote(x.contiguous())
    NT = dev.num_row_tiles
    store = not dev.has_work and dev.dia_vals is not None
    if store:
        tiles = x.new_empty((NT, LANES))
    elif not dev.has_work:
        tiles = _zeros(x, (NT, LANES))
    elif dev.sparse_stream and not dev.grouped:
        # post-peel residual: only rows with entries are touched
        tiles = f["bell2_acc"](dev.entries, x2d, _zeros(x2d, (NT, LANES)))
    else:
        tiles = f["bell2"](dev.vals, dev.packed, dev.meta, dev.step_block,
                           x2d, covers=dev.covers, **dev.stream_kw())
    if dev.grouped:
        ot = _unperm_tiles(dev, tiles, f["unperm"])
        if dev.dia_vals is None:
            return ot.reshape(-1)[: dev.nrows]
        tiles = ot[: -(-dev.nrows // LANES)]
    if dev.dia_vals is not None:
        tiles = f["sdia_gen"](dev.dia_vals, x2d, tiles, dev.dia_offsets,
                              store)
    return tiles.reshape(-1)[: dev.nrows]


def bell2_apply_mm(dev: Bell2Device, x: torch.Tensor, *, plain: bool = False):
    """Y = A X for X (ncols, B): :func:`bell2_apply` branch for branch,
    as the reference's ``bell2_apply_mm``, over (B, rows, 128) planes —
    the multi-RHS stream, unpermute and SDIA kernels in place of the
    single-vector ones. The full stream reads X interleaved
    (``bell2_kernel.interleave_x``, one padded copy), and the SDIA stream
    reads that copy where there is one, else X in place where it can
    (``sdia_kernel.gen_x``); only the sparse residual's entries read X as
    padded planes (``pad_x_mm``). Returns (nrows, B), a transposed view
    of the output planes. In float64 the full stream's double kernel reads
    padded planes instead (``bell2_df.bell2_spmm_tiles_df``)."""
    B = _check_matrix(x)
    f64 = x.dtype == torch.float64
    f = _kernels(plain, x.dtype)
    NT = dev.num_row_tiles
    full = dev.has_work and not (dev.sparse_stream and not dev.grouped)
    x_il = bk.interleave_x(x, dev.x_rows) if full and not f64 else None
    store = not dev.has_work and dev.dia_vals is not None
    if store:
        tiles = x.new_empty((B, NT, LANES))
    elif not dev.has_work:
        tiles = _zeros(x, (B, NT, LANES))
    elif not full:
        tiles = f["bell2_acc_mm"](dev.entries, pad_x_mm(x, dev.x_rows),
                                  _zeros(x, (B, NT, LANES)))
    elif f64:
        tiles = f["bell2_mm"](dev.vals, dev.packed, dev.meta, dev.step_block,
                              pad_x_mm(x, dev.x_rows), covers=dev.covers,
                              **dev.stream_kw())
    else:
        tiles = f["bell2_mm"](dev.vals, dev.packed, dev.meta, dev.step_block,
                              x_il, planes=B, covers=dev.covers,
                              **dev.stream_kw())
    if dev.grouped:
        ot = _unperm_tiles_mm(dev, tiles, f["unperm_mm"])
        if dev.dia_vals is None:
            return ot.reshape(B, -1)[:, : dev.nrows].T
        tiles = ot[:, : -(-dev.nrows // LANES)]
    if dev.dia_vals is not None:
        xg = x_il if x_il is not None else sk.gen_x(x, dev.x_rows)
        tiles = f["sdia_gen_mm"](dev.dia_vals, xg, tiles, dev.dia_offsets,
                                 planes=B, store=store)
    return tiles.reshape(B, -1)[:, : dev.nrows].T


def _count_far(fd: Bell2Device | None) -> None:
    """Count the far stream's form an apply runs: ``sbell.far_grouped``
    (the grouped stream and its unpermute) or ``sbell.far_entries`` (the
    sparse residual's entries added into tiles); ``sbell_apply``'s one
    pass over the entries' rows counts ``sbell.far_rows`` instead."""
    if fd is not None:
        trace.count("sbell.far_grouped" if fd.grouped
                    else "sbell.far_entries")


def _rows_pass(dev: SBellDevice, x: torch.Tensor) -> bool:
    """Whether :func:`sbell_apply` runs ``bell2_entries_rows``: the far
    stream's row pointers were built, and the plan still has neither a
    paired nor a diagonal stream (``DistSpDMV`` lays its diagonals over an
    uploaded plan), for a float32 x."""
    return (dev.far_rows is not None and not dev.has_paired
            and dev.dia_vals is None and x.dtype == torch.float32)


def sbell_apply(dev: SBellDevice, x: torch.Tensor, *, plain: bool = False):
    """Symmetric y = (D + L + Lᵀ) x, composed as the reference's
    ``sbell_apply``: the paired stream's tiles, or (without one) the
    accumulating streams seeded with D x; the degree-grouped far stream
    unpermuted and added (padded to the plan's tiles) — in one launch of
    the unpermute, which takes the seed D x (``seed``) or adds into the
    paired stream's tiles (``into``) — or the sparse far stream's entries
    accumulated straight into the tiles; the SDIA stream added in place
    (``sdia_gen_tiles`` when its offsets are mirrored, else
    ``sdia_sym_tiles``); then D x when the paired stream ran. Where the
    far stream's float32 entries are the whole off-diagonal part
    (``dev.far_rows``) and x is float32, one pass writes y = D x + R x
    from x as it lies (``bell2_entries_rows``; counter
    ``sbell.far_rows``). ``plain=True`` runs every stream through its
    plain twin.
    """
    _check_vector(x, "sbell_apply_mm")
    if _rows_pass(dev, x):
        trace.count("sbell.far_rows")
        return _STREAMS["bell2_rows"][plain](dev.far.entries, dev.far_rows,
                                             dev.diag, x.contiguous())
    f = _kernels(plain, x.dtype)
    x2d = pad_x(x, dev.x_rows)
    NT = dev.num_row_tiles
    tiles = None
    if dev.has_paired:
        tiles = f["sbell"](
            dev.vals, dev.packed, dev.meta, dev.step_block, x2d,
            num_row_tiles=NT, chunks_per_step=dev.chunks_per_step,
            tiles_per_block=dev.tiles_per_block,
            transpose_windows=dev.transpose_windows,
        )
    fd = dev.far
    _count_far(fd)
    if fd is not None and fd.grouped:
        # degree-grouped far stream: dense over its compact tiles, then
        # unpermuted onto the seed or into the paired stream's tiles
        ftiles = f["bell2"](fd.vals, fd.packed, fd.meta, fd.step_block,
                            x2d, covers=fd.covers, **fd.stream_kw())
        fused = (dict(seed=(dev.diag, x), tiles=NT) if tiles is None
                 else dict(into=tiles))
        tiles = _unperm_tiles(fd, ftiles, f["unperm"], **fused)
    else:
        if tiles is None:  # seed the accumulating streams with D x
            tiles = pad_x(_diag_term(dev.diag, x), NT)
        if fd is not None:
            # sparse far residual accumulates straight into the tiles
            tiles = f["bell2_acc"](fd.entries, x2d, tiles)
    if dev.dia_vals is not None and dev.dia_mirrored:
        tiles = f["sdia_gen"](dev.dia_vals, x2d, tiles[:NT], dev.dia_offsets,
                              window=dev.dia_window)
    elif dev.dia_vals is not None:
        tiles = f["sdia_sym"](dev.dia_vals, x2d, tiles[:NT], dev.dia_offsets)
    y = tiles.reshape(-1)[: dev.nrows]
    return _plus_diag(y, dev.diag, x) if dev.has_paired else y


def sbell_apply_mm(dev: SBellDevice, x: torch.Tensor, *, plain: bool = False):
    """Symmetric Y = (D + L + Lᵀ) X for X (nrows, B): :func:`sbell_apply`
    branch for branch, as the reference's ``sbell_apply_mm``, over (B,
    rows, 128) planes — the ``diag[:, None] * X`` seed (taken by the
    unpermute, which reads X in place, where the far stream is grouped) or
    the final add, the grouped far stream (which reads X interleaved,
    ``bell2_kernel.interleave_x``) unpermuted onto the seed or into the
    paired stream's planes, the sparse far residual's entries accumulated
    straight into the tiles, ``sdia_gen_tiles_mm`` when the diagonals are
    mirrored (X interleaved: the far stream's copy, or X in place,
    ``sdia_kernel.gen_x``), else ``sdia_sym_tiles_mm``. X travels as
    padded planes (``pad_x_mm``) only to the paired stream, the sparse
    residual and ``sdia_sym_tiles_mm``. Returns (nrows, B), a transposed
    view (or, with a paired stream, a fresh sum)."""
    B = _check_matrix(x)
    f = _kernels(plain, x.dtype)
    fd = dev.far
    _count_far(fd)
    grouped = fd is not None and fd.grouped
    sym_dia = dev.dia_vals is not None and not dev.dia_mirrored
    if dev.has_paired or sym_dia or (fd is not None and not grouped):
        x3d = pad_x_mm(x, dev.x_rows)
    x_il = bk.interleave_x(x, dev.x_rows) if grouped else None
    NT = dev.num_row_tiles
    tiles = None
    if dev.has_paired:
        tiles = f["sbell_mm"](
            dev.vals, dev.packed, dev.meta, dev.step_block, x3d,
            num_row_tiles=NT, chunks_per_step=dev.chunks_per_step,
            tiles_per_block=dev.tiles_per_block,
            transpose_windows=dev.transpose_windows,
        )
    if grouped:
        ftiles = f["bell2_mm"](fd.vals, fd.packed, fd.meta, fd.step_block,
                               x_il, planes=B, covers=fd.covers,
                               **fd.stream_kw())
        fused = (dict(seed=(dev.diag, x), tiles=NT) if tiles is None
                 else dict(into=tiles))
        tiles = _unperm_tiles_mm(fd, ftiles, f["unperm_mm"], **fused)
    else:
        if tiles is None:
            tiles = pad_x_mm(_diag_term(dev.diag, x), NT)
        if fd is not None:
            tiles = f["bell2_acc_mm"](fd.entries, x3d, tiles)
    if dev.dia_vals is not None and dev.dia_mirrored:
        xg = x_il if x_il is not None else sk.gen_x(x, dev.x_rows)
        tiles = f["sdia_gen_mm"](dev.dia_vals, xg, tiles[:, :NT],
                                 dev.dia_offsets, planes=B,
                                 window=dev.dia_window)
    elif dev.dia_vals is not None:
        tiles = f["sdia_sym_mm"](dev.dia_vals, x3d, tiles[:, :NT],
                                 dev.dia_offsets, stage_x=dev.dia_stage_x)
    Y = tiles.reshape(B, -1)[:, : dev.nrows].T
    return _plus_diag(Y, dev.diag, x) if dev.has_paired else Y


def _check_fp64(x):
    if x.dtype != torch.float64:
        raise TypeError(f"x is {x.dtype} but the plan was tuned for "
                        "torch.float64")


def fp64_apply(dev: Fp64Device, x: torch.Tensor, *, plain: bool = False):
    """y = A x in float64. A plan whose stream travels as entries (a peel
    residual or sparse stream) starts from zero tiles of the result's
    height and adds the entries into them (``bell2_spmv_tiles_accum_df``);
    otherwise the one-sided stream writes its tiles
    (``bell2_spmv_tiles_df``), its rows gathered back to their order when
    the plan is degree-grouped (a plain gather against a zero appended to
    the stream's output, as in the reference's applier). Then the
    symmetric diagonal stream adds in place (``sdia_sym_tiles_df``), as
    ``sbell_apply`` seeds its accumulating streams. x is padded once, to
    the taller of the two streams' x operands. An empty matrix gives
    zeros. ``plain=True`` runs every stream through its twin."""
    _check_vector(x, "fp64_apply_mm")
    _check_fp64(x)
    f = _kernels(plain)
    TD = -(-dev.nrows // LANES)  # tiles of the result
    x2d = pad_x(x, max(dev.x_rows, TD))
    if dev.entries is not None:
        tiles = f["bell2_acc_df"](dev.entries, x2d, _zeros(x2d, (TD, LANES)))
    elif dev.has_work:
        tiles = f["bell2_df"](dev.vals, dev.packed, dev.meta, dev.step_block,
                              x2d, covers=dev.covers, **dev.stream_kw())
        if dev.grouped:
            tiles = _gather_rows(tiles, dev.row_perm).view(TD, LANES)
    else:
        tiles = _zeros(x2d, (TD, LANES))
    if dev.dia_vals is not None:
        tiles = f["sdia_df"](dev.dia_vals, x2d, tiles[:TD], dev.dia_offsets)
    return tiles.reshape(-1)[: dev.nrows]


def _rows_path(dev: Fp64Device, x: torch.Tensor) -> bool:
    """Whether :func:`fp64_apply_mm` runs the row-major diagonal kernel:
    a plan of diagonals only (no stream, no entries) and X as that kernel
    reads it in place (``sdia_df.rows_x``)."""
    return (dev.entries is None and not dev.has_work
            and dev.dia_vals is not None and dev.nrows == x.shape[0]
            and sdf.rows_x(x))


def fp64_apply_mm(dev: Fp64Device, x: torch.Tensor, *, plain: bool = False):
    """Y = A X in float64 for X (ncols, B). A plan of diagonals only, with
    X a contiguous (n, B) of even B whose rows are 16-byte aligned, runs
    ``sdia_sym_rows_df_mm`` on X as it lies and returns its fresh,
    contiguous (nrows, B) Y (counter ``fp64_mm.rows``). Otherwise
    (``fp64_mm.planes``) :func:`fp64_apply` branch for branch over (B,
    rows, 128) planes (``bell2_spmm_tiles_accum_df``,
    ``bell2_spmm_tiles_df``, ``sdia_sym_tiles_df_mm``) and a transposed
    view of the output planes; any B runs in groups of up to
    ``_cuda.RHS_GROUP`` columns or planes inside the wrappers."""
    B = _check_matrix(x)
    _check_fp64(x)
    f = _kernels(plain)
    if _rows_path(dev, x):
        trace.count("fp64_mm.rows", 1)
        return f["sdia_rows_df_mm"](dev.dia_vals, x, dev.dia_offsets)
    trace.count("fp64_mm.planes", 1)
    TD = -(-dev.nrows // LANES)
    x3d = pad_x_mm(x, max(dev.x_rows, TD))
    if dev.entries is not None:
        tiles = f["bell2_acc_df_mm"](dev.entries, x3d,
                                     _zeros(x3d, (B, TD, LANES)))
    elif dev.has_work:
        tiles = f["bell2_df_mm"](dev.vals, dev.packed, dev.meta,
                                 dev.step_block, x3d, covers=dev.covers,
                                 **dev.stream_kw())
        if dev.grouped:
            tiles = _gather_rows(tiles, dev.row_perm, B).view(B, TD, LANES)
    else:
        tiles = _zeros(x3d, (B, TD, LANES))
    if dev.dia_vals is not None:
        tiles = f["sdia_df_mm"](dev.dia_vals, x3d, tiles[:, :TD],
                                dev.dia_offsets, stage_x=dev.dia_stage_x)
    return tiles.reshape(B, -1)[:, : dev.nrows].T
