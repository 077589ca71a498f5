"""Op-level SpMV: plan → device tensors → padded kernel calls.

Port of ``cfs_spmv_tpu/ops/spmv.py`` for the tuned symmetric fp32 path:
it owns padding/unpadding and the composition of streams (diagonal seed,
degree-grouped or sparse far residual, dense-diagonal SDIA stream). The
device structs are plain dataclasses of tensors on one explicit device.

Off the slice, and raising ``NotImplementedError``: the paired symmetric
stream (kernel B5, ROADMAP A3), signed or mirrored SDIA offsets (B6),
the general ``bell2_apply`` path (A4) and a 2-D ``x`` (SpMM, A7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.bell2 import LANES, SUBLANES
from .bell2_kernel import (
    bell2_spmv_tiles,
    bell2_spmv_tiles_accum,
    bell2_spmv_tiles_accum_plain,
    bell2_spmv_tiles_plain,
    unperm_gather_tiles,
    unperm_gather_tiles_plain,
)
from .sdia_kernel import sdia_sym_tiles, sdia_sym_tiles_plain

__all__ = [
    "Bell2Device",
    "SBellDevice",
    "as_device",
    "to_device",
    "sym_to_device",
    "pad_x",
    "bell2_apply",
    "sbell_apply",
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
    """Device-resident one-sided BELL2 stream (the symmetric far stream)."""

    vals: torch.Tensor  # (C*8, 128) float32
    packed: torch.Tensor  # (C*8, 128) int16, q | r2 << 7
    meta: torch.Tensor  # (C, 10) int32
    step_block: torch.Tensor  # (C/K,) int32
    num_row_tiles: int
    chunks_per_step: int
    tiles_per_block: int
    #: x row is ``meta[c, 2] + r2`` (contiguous or deep windows), else
    #: ``meta[c, 2 + (r2 & 7)]`` (listed windows)
    contig: bool
    #: degree-grouped row tiling (``formats/bell2.Bell2Plan.row_perm``):
    #: the compact output is unpermuted by ``unperm_gather_tiles``
    unperm_pk: torch.Tensor | None = None  # (nb*8, 128) int32
    unperm_slabs: torch.Tensor | None = None  # (nb, W) int32

    @property
    def grouped(self) -> bool:
        return self.unperm_pk is not None


@dataclasses.dataclass
class SBellDevice:
    """Device-resident symmetric plan: diagonal + far residual + SDIA."""

    diag: torch.Tensor  # (nrows,) float32
    far: Bell2Device | None
    num_row_tiles: int
    x_rows: int
    nrows: int
    dia_vals: torch.Tensor | None = None  # (R, D, 8, 128) float32
    dia_offsets: torch.Tensor | None = None  # (D,) int32, all >= 1


def _tensor(a, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _check_stream_plan(plan, contig):
    """Host-side index checks of a one-sided stream, once per upload: the
    kernels trust these ranges and read without bounds checks."""
    meta = np.asarray(plan.meta)
    K, C = plan.chunks_per_step, meta.shape[0]
    if plan.lane_rot != 1 or plan.max_windows != SUBLANES:
        raise NotImplementedError(
            "lane rotation and capped window stacks were pruned from the "
            "reference planner; the port takes rot=1, 8-window plans only"
        )
    if C % K or len(plan.step_block) != C // K:
        raise ValueError("stream not padded to whole K-chunk steps")
    if C and (meta[:, 0].max() >= plan.tiles_per_block or meta[:, 0].min() < 0):
        raise ValueError("meta sub row outside its output block")
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


def to_device(plan, device) -> Bell2Device:
    """Upload a one-sided ``Bell2Plan`` (the port's or the reference's:
    the fields and dtypes are the same) to ``device``."""
    device = as_device(device)
    if getattr(plan, "dia", None) is not None:
        raise NotImplementedError(
            "the signed-offset dia stream of a general plan runs "
            "sdia_gen_tiles (kernel B6), not ported yet: ROADMAP A4"
        )
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
    return Bell2Device(
        vals=t(plan.vals),
        packed=t(plan.packed),
        meta=t(plan.meta),
        step_block=t(plan.step_block),
        num_row_tiles=plan.num_row_tiles,
        chunks_per_step=plan.chunks_per_step,
        tiles_per_block=plan.tiles_per_block,
        contig=contig,
        unperm_pk=t(plan.unperm_pk),
        unperm_slabs=t(plan.unperm_slabs),
    )


def sym_to_device(plan, device) -> SBellDevice:
    """Upload a symmetric ``SBellPlan`` (the port's or the reference's) to
    ``device``. The paired stream and signed SDIA offsets raise."""
    device = as_device(device)
    if plan.nnz_paired:
        raise NotImplementedError(
            "the paired symmetric stream (sbell_spmv_tiles, kernel B5) is "
            "not ported yet: ROADMAP A3 (reachable with CFS_PAIRED=force)"
        )
    offsets = () if plan.dia is None else tuple(int(d) for d in plan.dia.offsets)
    if any(d <= 0 for d in offsets):
        raise NotImplementedError(
            "signed or mirrored SDIA offsets run sdia_gen_tiles (kernel "
            "B6), not ported yet: ROADMAP A4"
        )
    far = None
    if plan.far is not None:
        if plan.far.x_rows > plan.x_rows:
            raise ValueError("far stream windows exceed the shared x")
        far = to_device(plan.far, device)
    return SBellDevice(
        diag=_tensor(plan.diag, device),
        far=far,
        num_row_tiles=plan.num_row_tiles,
        x_rows=plan.x_rows,
        nrows=plan.nrows,
        dia_vals=None if plan.dia is None else _tensor(plan.dia.vals, device),
        dia_offsets=None if plan.dia is None
        else torch.tensor(offsets, dtype=torch.int32, device=device),
    )


def pad_x(x: torch.Tensor, x_rows: int) -> torch.Tensor:
    """(m,) → (x_rows, 128) zero-padded segment-sliceable layout."""
    m = x.shape[0]
    return torch.nn.functional.pad(x, (0, x_rows * LANES - m)).reshape(
        x_rows, LANES
    )


def _unperm_tiles(dev: Bell2Device, tiles, unperm=unperm_gather_tiles):
    """Original-row-order tiles (>= ceil(nrows/128) rows of 128) from a
    grouped stream's compact output tiles; absent rows read exact 0."""
    return unperm(dev.unperm_pk, dev.unperm_slabs, tiles[: dev.num_row_tiles])


def bell2_apply(dev, x):
    """The general one-sided path (``cfs_spmv_tpu/ops/spmv.bell2_apply``)."""
    raise NotImplementedError(
        "the general path bell2_apply is not ported yet: ROADMAP A4"
    )


def sbell_apply(dev: SBellDevice, x: torch.Tensor, *, plain: bool = False):
    """Symmetric y = (D + L + Lᵀ) x, composed exactly as the reference's
    ``sbell_apply`` without a paired stream: the accumulating streams are
    seeded with D x, the degree-grouped far stream is unpermuted and
    added (padded to the plan's tiles), the sparse far stream accumulates
    into the tiles padded to its block multiple, and the SDIA stream adds
    its banded part in place.

    ``plain=True`` runs every stream through its plain PyTorch twin on
    whatever device the tensors live on — the baseline the kernels are
    timed and checked against.
    """
    if x.ndim != 1:
        raise NotImplementedError(
            "SpMM (2-D x, sbell_apply_mm) is not ported yet: ROADMAP A7"
        )
    if plain:
        bell2, bell2_acc, unperm, sdia = (
            bell2_spmv_tiles_plain, bell2_spmv_tiles_accum_plain,
            unperm_gather_tiles_plain, sdia_sym_tiles_plain,
        )
    else:
        bell2, bell2_acc, unperm, sdia = (
            bell2_spmv_tiles, bell2_spmv_tiles_accum,
            unperm_gather_tiles, sdia_sym_tiles,
        )
    x2d = pad_x(x, dev.x_rows)
    # seed the accumulating streams with D x directly (no paired stream)
    tiles = pad_x(dev.diag * x, dev.num_row_tiles)
    NT = dev.num_row_tiles
    fd = dev.far
    if fd is not None:
        kw = dict(
            num_row_tiles=fd.num_row_tiles,
            chunks_per_step=fd.chunks_per_step,
            tiles_per_block=fd.tiles_per_block,
            contig=fd.contig,
        )
        if fd.grouped:
            # degree-grouped far stream: dense over its compact tiles;
            # unpermute, then add into the seeded tiles
            ftiles = bell2(fd.vals, fd.packed, fd.meta, fd.step_block, x2d,
                           **kw)
            ot = _unperm_tiles(fd, ftiles, unperm)
            if ot.shape[0] < NT:
                ot = torch.nn.functional.pad(ot, (0, 0, 0, NT - ot.shape[0]))
            tiles = tiles[:NT] + ot[:NT]
        else:
            # sparse far residual accumulates straight into the seeded
            # tiles (unvisited blocks keep their values)
            BT = fd.tiles_per_block
            TP = -(-fd.num_row_tiles // BT) * BT
            tp = torch.nn.functional.pad(tiles, (0, 0, 0, TP - tiles.shape[0]))
            tiles = bell2_acc(fd.vals, fd.packed, fd.meta, fd.step_block,
                              x2d, tp, **kw)[:NT]
    if dev.dia_vals is not None:
        tiles = sdia(dev.dia_vals, x2d, tiles, dev.dia_offsets)
    return tiles.reshape(-1)[: dev.nrows]
