"""Float64 SDIA — the symmetric dense-diagonal stream in IEEE double.

Ports of ``cfs_spmv_tpu/ops/sdia_df.py``:

- ``sdia_sym_tiles_df`` (kernel B13): ``y += (L + D + Lᵀ) x`` in double;
- ``sdia_sym_tiles_df_mm`` (B14): the same for B right-hand sides, X as
  (B, x_rows, 128) and Y as (B, T, 128) planes, the value planes read
  once per group of up to ``_cuda.RHS_GROUP`` planes.

The reference carries every value, x and sum as an fp32 (hi, lo) pair
with error-free transforms, because its chip has no 64-bit lanes. What it
computes is the symmetric diagonal stream in double, so the port runs the
``double`` instance of B1's CUDA kernel (``sdia_sym_kernel<double, kRhs>``
in ``csrc/spmv_kernels.cu``) on float64 ``vals``, x and y: no pairs, no
split of x, no fold of y. The plain twins are B1's
(``sdia_kernel.sdia_sym_tiles_plain``), which compute in the operands'
type.

The main diagonal (offset 0) may be one of the stored diagonals. The
tuner halves its values (exact in binary), and the kernel's row side and
transpose side, which for offset 0 both land on row g, sum to the full
diagonal term.

Unlike the reference's functions, which return fresh tiles, these
accumulate into ``y_tiles`` in place like B1 and B11: the float64 applier
adds the diagonal stream onto the one-sided stream's result.
"""

from __future__ import annotations

import torch

from . import sdia_kernel as sk

__all__ = ["sdia_sym_tiles_df", "sdia_sym_tiles_df_mm"]


def sdia_sym_tiles_df(vals, x2d, y_tiles, offsets):
    """``y_tiles += (L + D + Lᵀ) x`` in float64.

    ``vals``: (R, D, 8, 128) float64, the offset-0 plane (if any) holding
    half the main diagonal; ``x2d``: (x_rows, 128) float64, read as zero
    beyond its end; ``y_tiles``: (T, 128) float64, accumulated in place
    and returned; ``offsets``: (D,) int32, each ``>= 0``.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    sk._check(vals, x2d, y_tiles, offsets, torch.float64)
    if vals.device.type == "cpu":
        return sk.sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets)
    sdia_sym_tiles_df.launches += sk._launch_sym(
        vals, x2d[None], y_tiles[None], offsets, "sdia_sym_tiles_df")
    return y_tiles


def sdia_sym_tiles_df_mm(vals, x3d, y_tiles, offsets, stage_x=False):
    """``Y_tiles += (L + D + Lᵀ) X`` in float64 for B right-hand sides:
    ``x3d`` (B, x_rows, 128) and ``y_tiles`` (B, T, 128) float64 stacks
    whose planes are each contiguous (any plane stride); ``stage_x`` as
    in ``sdia_kernel.sdia_sym_tiles_mm``. Otherwise as
    :func:`sdia_sym_tiles_df`, plane by plane; a CUDA tensor launches
    once per group of up to ``_cuda.RHS_GROUP`` planes."""
    sk._check_mm(vals, x3d, y_tiles, offsets, torch.float64)
    if vals.device.type == "cpu":
        return sk.sdia_sym_tiles_mm_plain(vals, x3d, y_tiles, offsets)
    sdia_sym_tiles_df_mm.launches += sk._launch_sym(
        vals, x3d, y_tiles, offsets, "sdia_sym_tiles_df_mm", stage_x)
    return y_tiles


#: launches of the CUDA kernel through these wrappers (never the twins)
sdia_sym_tiles_df.launches = 0
sdia_sym_tiles_df_mm.launches = 0
