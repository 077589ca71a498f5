"""BELL2 one-sided stream and grouped unpermute: CUDA wrappers + twins.

Ports of the Pallas kernels in ``cfs_spmv_tpu/ops/bell2_kernel.py`` that
the tuned symmetric path reaches:

- ``bell2_spmv_tiles`` (kernel B2): ``y = A x`` for one stream; the
  blocks the stream visits are zeroed first, the others left unset;
- ``bell2_spmv_tiles_accum`` (B4): the same stream added into a given
  ``y`` (sparse far residuals, which visit few blocks);
- ``unperm_gather_tiles`` (B3): original-order rows from a
  degree-grouped stream's compact output tiles.

A chunk is an (8, 128) slot grid. Slot (i, j) of chunk c holds the gather
lane ``q = pk & 0x7F``; the window index ``r2`` serving gather lane q of
sublane i sits in bits 7-11 of the packed word at lane q. The x row is
``meta[c, 2] + r2`` for contiguous/deep windows and ``meta[c, 2 + (r2 & 7)]``
for listed ones; the 8 sublanes sum into tile row
``step_block[c // K] * BT + meta[c, 0]``.

The TPU-only stream forms (``nib_split``, ``meta_word``, the segmented
word path) are not ported: the CUDA kernel reads the plan's int16
``packed`` and (C, 10) ``meta`` as they are.
"""

from __future__ import annotations

import torch

from . import _cuda

SUBLANES = 8
LANES = 128
META_W = 2 + SUBLANES

__all__ = [
    "bell2_spmv_tiles",
    "bell2_spmv_tiles_accum",
    "bell2_spmv_tiles_plain",
    "bell2_spmv_tiles_accum_plain",
    "unperm_gather_tiles",
    "unperm_gather_tiles_plain",
]


def _tiles_padded(num_row_tiles: int, tiles_per_block: int) -> int:
    return -(-num_row_tiles // tiles_per_block) * tiles_per_block


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_stream(vals, packed, meta, step_block, x2d, K):
    C = meta.shape[0]
    if meta.ndim != 2 or meta.shape[1] != META_W or meta.dtype != torch.int32:
        raise ValueError(
            f"meta must be (C, {META_W}) int32, got {tuple(meta.shape)} "
            f"{meta.dtype}"
        )
    if tuple(vals.shape) != (C * SUBLANES, LANES) or vals.dtype != torch.float32:
        raise ValueError(f"vals must be ({C * SUBLANES}, 128) float32")
    if tuple(packed.shape) != (C * SUBLANES, LANES) or packed.dtype != torch.int16:
        raise ValueError(f"packed must be ({C * SUBLANES}, 128) int16")
    if C % K:
        raise ValueError(f"chunk stream not padded to K={K} (C={C})")
    if tuple(step_block.shape) != (C // K,) or step_block.dtype != torch.int32:
        raise ValueError(f"step_block must be ({C // K},) int32")
    if x2d.ndim != 2 or x2d.shape[1] != LANES or x2d.dtype != torch.float32:
        raise ValueError("x2d must be (x_rows, 128) float32")


def _row_sums_plain(vals, packed, meta, step_block, x2d, K, BT, contig):
    """(target tile per chunk, (C, 128) sublane-summed products)."""
    C = meta.shape[0]
    pk = packed.reshape(C, SUBLANES, LANES).to(torch.int64)
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 0x1F, 2, q)  # the field at lane q
    meta64 = meta.to(torch.int64)
    if contig:
        xrow = meta64[:, 2, None, None] + r2
    else:
        cidx = torch.arange(C, device=meta.device)[:, None, None]
        xrow = meta64[:, 2:].reshape(-1)[cidx * SUBLANES + (r2 & 7)]
    xv = x2d.reshape(-1)[xrow * LANES + q]
    rows = (vals.reshape(C, SUBLANES, LANES) * xv).sum(dim=1)
    tgt = (
        step_block.to(torch.int64).repeat_interleave(K) * BT + meta64[:, 0]
    )
    return tgt, rows


def bell2_spmv_tiles_plain(vals, packed, meta, step_block, x2d, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           contig, out=None):
    """Plain PyTorch twin of :func:`bell2_spmv_tiles` (any device):
    vectorised gather over all chunks, sum over sublanes, ``index_add_``."""
    K, BT = chunks_per_step, tiles_per_block
    TP = _tiles_padded(num_row_tiles, BT)
    if out is None:
        out = torch.empty((TP, LANES), dtype=x2d.dtype, device=x2d.device)
    out.view(-1, BT, LANES)[torch.unique(step_block).long()] = 0
    tgt, rows = _row_sums_plain(vals, packed, meta, step_block, x2d, K, BT,
                                contig)
    out.index_add_(0, tgt, rows)
    return out[:num_row_tiles]


def bell2_spmv_tiles_accum_plain(vals, packed, meta, step_block, x2d,
                                 y_tiles, *, num_row_tiles, chunks_per_step,
                                 tiles_per_block, contig):
    """Plain PyTorch twin of :func:`bell2_spmv_tiles_accum` (any device)."""
    tgt, rows = _row_sums_plain(vals, packed, meta, step_block, x2d,
                                chunks_per_step, tiles_per_block, contig)
    y_tiles.index_add_(0, tgt, rows)
    return y_tiles


def _launch_bell2(vals, packed, meta, step_block, x2d, y, K, BT, contig,
                  zero_blocks, name):
    lib = _cuda.lib()
    with torch.cuda.device(y.device):
        err = lib.cfs_bell2_spmv(
            vals.data_ptr(), packed.data_ptr(), meta.data_ptr(),
            step_block.data_ptr(), meta.shape[0], K, BT, int(contig),
            int(zero_blocks), x2d.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _cuda.check(err, name)


def bell2_spmv_tiles(vals, packed, meta, step_block, x2d, *,
                     num_row_tiles, chunks_per_step, tiles_per_block,
                     contig, out=None):
    """y tiles (T, 128) = A @ x for one BELL2 stream.

    ``vals``/``packed``: (C*8, 128) float32/int16; ``meta``: (C, 10)
    int32; ``step_block``: (C/K,) int32; ``x2d``: (x_rows, 128) float32.
    ``contig`` selects contiguous/deep windows (x row ``meta[c,2] + r2``)
    over listed ones. The output is a (ceil(T/BT)*BT, 128) buffer
    (``out``, or ``torch.empty``) of which the blocks the stream visits
    are zeroed and accumulated; unvisited blocks keep whatever the buffer
    held. Returns its first T rows.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    K, BT = chunks_per_step, tiles_per_block
    dev = _device_of(vals, packed, meta, step_block, x2d)
    _check_stream(vals, packed, meta, step_block, x2d, K)
    TP = _tiles_padded(num_row_tiles, BT)
    if out is None:
        out = torch.empty((TP, LANES), dtype=x2d.dtype, device=dev)
    elif (tuple(out.shape) != (TP, LANES) or out.dtype != x2d.dtype
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({TP}, 128) float32 "
                         f"tensor on {dev}")
    if dev.type == "cpu":
        return bell2_spmv_tiles_plain(
            vals, packed, meta, step_block, x2d,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, contig=contig, out=out,
        )
    _launch_bell2(vals, packed, meta, step_block, x2d, out, K, BT, contig,
                  True, "bell2_spmv_tiles")
    bell2_spmv_tiles.launches += 1
    return out[:num_row_tiles]


def bell2_spmv_tiles_accum(vals, packed, meta, step_block, x2d, y_tiles, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           contig):
    """``y_tiles += A @ x`` for a sparse accumulating BELL2 stream.

    ``y_tiles``: (ceil(T/BT)*BT, 128) float32, added into in place (the
    reference aliases it; blocks without chunks keep their values) and
    returned. Other operands as :func:`bell2_spmv_tiles`.
    """
    K, BT = chunks_per_step, tiles_per_block
    dev = _device_of(vals, packed, meta, step_block, x2d, y_tiles)
    _check_stream(vals, packed, meta, step_block, x2d, K)
    TP = _tiles_padded(num_row_tiles, BT)
    if tuple(y_tiles.shape) != (TP, LANES) or y_tiles.dtype != x2d.dtype:
        raise ValueError(f"y_tiles must be ({TP}, 128) float32")
    if dev.type == "cpu":
        return bell2_spmv_tiles_accum_plain(
            vals, packed, meta, step_block, x2d, y_tiles,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, contig=contig,
        )
    _launch_bell2(vals, packed, meta, step_block, x2d, y_tiles, K, BT,
                  contig, False, "bell2_spmv_tiles_accum")
    bell2_spmv_tiles_accum.launches += 1
    return y_tiles


def unperm_gather_tiles_plain(pk2d, rows, g_tiles):
    """Plain PyTorch twin of :func:`unperm_gather_tiles` (any device):
    one flat gather plus ``where``; rows with ``pk < 0`` read exact 0."""
    pk = pk2d.reshape(-1).to(torch.int64)
    W = rows.shape[1]
    blk = torch.arange(pk.shape[0], device=pk.device) >> 10
    p = pk.clamp(min=0)
    tile = rows.reshape(-1).to(torch.int64)[blk * W + (p >> 7)]
    v = g_tiles.reshape(-1)[tile * LANES + (p & 0x7F)]
    out = torch.where(pk < 0, torch.zeros_like(v), v)
    return out.reshape(pk2d.shape)


def unperm_gather_tiles(pk2d, rows, g_tiles):
    """(nb*8, 128) original-order y tiles from grouped output tiles.

    ``pk2d``: (nb*8, 128) int32 words ``q | w << 7`` (-1: exact 0);
    ``rows``: (nb, W) int32 tile rows of ``g_tiles`` each 1024-row block
    reads; ``g_tiles``: (T, 128) float32. A pure gather, so the result is
    bit-exact on every device.
    """
    dev = _device_of(pk2d, rows, g_tiles)
    nb = rows.shape[0]
    if tuple(pk2d.shape) != (nb * SUBLANES, LANES) or pk2d.dtype != torch.int32:
        raise ValueError(f"pk2d must be ({nb * SUBLANES}, 128) int32")
    if rows.ndim != 2 or rows.dtype != torch.int32:
        raise ValueError("rows must be (nb, W) int32")
    if g_tiles.ndim != 2 or g_tiles.shape[1] != LANES or g_tiles.dtype != torch.float32:
        raise ValueError("g_tiles must be (T, 128) float32")
    if dev.type == "cpu":
        return unperm_gather_tiles_plain(pk2d, rows, g_tiles)
    out = torch.empty((nb * SUBLANES, LANES), dtype=g_tiles.dtype,
                      device=dev)
    lib = _cuda.lib()
    with torch.cuda.device(dev):
        err = lib.cfs_unperm_gather(
            pk2d.data_ptr(), rows.data_ptr(), rows.shape[1],
            g_tiles.data_ptr(), out.data_ptr(), out.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(err, "unperm_gather_tiles")
    unperm_gather_tiles.launches += 1
    return out


#: launches of the CUDA kernels through these wrappers (never the twins)
bell2_spmv_tiles.launches = 0
bell2_spmv_tiles_accum.launches = 0
unperm_gather_tiles.launches = 0
