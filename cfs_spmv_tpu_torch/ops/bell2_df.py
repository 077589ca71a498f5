"""Float64 BELL2 — the one-sided stream in IEEE double.

Ports of ``cfs_spmv_tpu/ops/bell2_df.py``:

- ``bell2_spmv_tiles_df`` (kernel B15): ``y = A x`` in double for one
  BELL2 stream, the blocks it visits zeroed first;
- ``bell2_spmm_tiles_df`` (B16): the same for B right-hand sides, X as
  (B, x_rows, 128) planes, the stream read once per group of up to
  ``_cuda.RHS_GROUP`` planes;
- ``bell2_spmv_tiles_accum_df`` and ``bell2_spmm_tiles_accum_df``: B15
  and B16 on a float64 peel residual or sparse stream. The upload
  (``ops/spmv.fp64_to_device``) compacts such a stream's chunk grid, under
  1% full, into a row-sorted entry list (``bell2_kernel.compact_stream``),
  and its entries are added into given tiles, as B4/B8 do in float32.

The reference carries values, x and sums as fp32 (hi, lo) pairs with
error-free transforms (its chip has no 64-bit lanes), writes an 8x-tall
output of sublane partials and folds it in float64 outside the kernel
(``fold_df_tiles``, ``_df_reduce8``). What it computes is the stream's
product in double, so the port runs the ``double`` instances of B2's and
B4's CUDA kernels (``bell2_spmv_kernel<contig, kRhs, double>`` with its
zero pass, ``bell2_entries_kernel<kRhs, double>``, ``csrc/spmv_kernels.cu``)
on float64 values, x and y: sums in double registers, flushed with
``atomicAdd(double*)``, so there are no pairs and nothing to fold. The
grid kernel reads the plan's int16 ``packed`` and (C, 10) ``meta`` as they
are, listed windows included, so no plan is turned away as not
word-eligible; it walks one chunk a CTA, and zeroes the whole planes in
one ``cudaMemset2DAsync`` when told that the stream visits every block
(``covers``), as the float instances do. The plain twins are B2's and
B4's (``bell2_kernel.bell2_spmv_tiles_plain``,
``bell2_spmv_tiles_accum_plain``), which compute in the operands' type.

``split_df`` is kept for comparing plans: the reference's double-float
plan stores ``split_df`` of the values the port stores whole.
"""

from __future__ import annotations

import torch

from . import bell2_kernel as bk

__all__ = ["bell2_spmv_tiles_df", "bell2_spmm_tiles_df",
           "bell2_spmv_tiles_accum_df", "bell2_spmm_tiles_accum_df",
           "split_df"]


def split_df(a):
    """(hi, lo) float32 pair of a float64 numpy array: ``hi`` is ``a``
    rounded to float32 and ``lo`` the rounded residual, as the reference's
    double-float plans store them."""
    hi = a.astype("float32")
    return hi, (a - hi.astype("float64")).astype("float32")


def bell2_spmv_tiles_df(vals, packed, meta, step_block, x2d, *,
                        num_row_tiles, chunks_per_step, tiles_per_block,
                        contig, out=None, covers=False):
    """y tiles (T, 128) = A @ x in float64 for one BELL2 stream.

    ``vals``: (C*8, 128) float64; ``x2d``: (x_rows, 128) float64; the
    output a (ceil(T/BT)*BT, 128) float64 buffer (``out``, or
    ``torch.empty``) whose visited blocks are zeroed and accumulated.
    ``covers=True`` says the stream visits every block: the whole buffer
    is zeroed in one pass, which is the same result. Everything else as
    :func:`bell2_kernel.bell2_spmv_tiles`.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    return bk._spmv_tiles(bell2_spmv_tiles_df, torch.float64, vals, packed,
                          meta, step_block, x2d, num_row_tiles,
                          chunks_per_step, tiles_per_block, contig, out,
                          covers)


def bell2_spmm_tiles_df(vals, packed, meta, step_block, x3d, *,
                        num_row_tiles, chunks_per_step, tiles_per_block,
                        contig, out=None, covers=False):
    """Y tiles (B, T, 128) = A @ X in float64 for one BELL2 stream and B
    right-hand sides: ``x3d`` (B, x_rows, 128) float64 planes, each
    contiguous; the output a contiguous (B, ceil(T/BT)*BT, 128) float64
    buffer. ``covers`` as :func:`bell2_spmv_tiles_df`; everything else as
    :func:`bell2_kernel.bell2_spmm_tiles`."""
    return bk._spmm_tiles(bell2_spmm_tiles_df, torch.float64, vals, packed,
                          meta, step_block, x3d, num_row_tiles,
                          chunks_per_step, tiles_per_block, contig, out,
                          covers)


def bell2_spmv_tiles_accum_df(entries, x2d, y_tiles):
    """``y_tiles += R @ x`` in float64 for a float64 peel residual or
    sparse stream R, given as its :class:`bell2_kernel.EntryStream` with
    float64 ``vals``: ``x2d`` (x_rows, 128) and ``y_tiles`` (T, 128)
    float64, T at least ``entries.min_tiles``. Rows no entry names keep
    their values bit for bit. Everything else, the note on non-finite x
    included, as :func:`bell2_kernel.bell2_spmv_tiles_accum`.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    return bk._spmv_accum(bell2_spmv_tiles_accum_df, torch.float64, entries,
                          x2d, y_tiles)


def bell2_spmm_tiles_accum_df(entries, x3d, y_tiles):
    """``Y_tiles += R @ X`` in float64 for B right-hand sides: ``x3d``
    (B, x_rows, 128) and ``y_tiles`` (B, T, 128) float64 planes, each
    contiguous (any plane stride); the entry list is read once per group
    of up to ``_cuda.RHS_GROUP`` planes. Everything else as
    :func:`bell2_spmv_tiles_accum_df`."""
    return bk._spmm_accum(bell2_spmm_tiles_accum_df, torch.float64, entries,
                          x3d, y_tiles)


#: launches of the CUDA kernels through these wrappers (never the twins);
#: an SpMM wrapper counts one per group of planes
bell2_spmv_tiles_df.launches = 0
bell2_spmm_tiles_df.launches = 0
bell2_spmv_tiles_accum_df.launches = 0
bell2_spmm_tiles_accum_df.launches = 0
