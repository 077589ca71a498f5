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

``sdia_sym_rows_df_mm`` is B14 again for a plan that is diagonals only,
over X and Y in the caller's row-major (n, B) layout: it returns a fresh
Y, stored (not added) by ``sdia_sym_rows_kernel`` a group of up to
``_cuda.RHS_GROUP`` columns a launch, one thread a row reading X's rows
where they lie, so the applier copies X into no planes and zeroes no
output. Its twin, :func:`sdia_sym_rows_plain`, computes the same sums
row-major.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda
from . import sdia_kernel as sk

__all__ = ["sdia_sym_tiles_df", "sdia_sym_tiles_df_mm",
           "sdia_sym_rows_df_mm", "sdia_sym_rows_plain", "rows_x"]


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


def rows_x(x) -> bool:
    """Whether ``sdia_sym_rows_df_mm`` takes X as it is: a contiguous (n,
    B) float64 tensor of even B whose rows are 16-byte aligned."""
    return (x.ndim == 2 and x.dtype == torch.float64 and x.is_contiguous()
            and x.shape[1] % 2 == 0 and x.shape[1] > 0
            and x.data_ptr() % 16 == 0)


def sdia_sym_rows_plain(vals, x, offsets):
    """Plain PyTorch twin of :func:`sdia_sym_rows_df_mm`: ``Y = (L + D +
    Lᵀ) X`` by flat shifted slices of the (n, B) X, one pair a diagonal,
    the row side then the transpose side as B1's twin adds them, into a
    fresh (n, B) Y of x's type. Runs on any device; ``offsets`` is a
    tensor or a sequence of ints ``>= 0``."""
    offs = offsets.tolist() if torch.is_tensor(offsets) else list(offsets)
    n, D = x.shape[0], vals.shape[1]
    vd = vals.to(x.dtype).permute(1, 0, 2, 3).reshape(D, -1)
    # value rows past x meet x's zeros; rows of x past the values, zeros
    vd = torch.nn.functional.pad(vd, (0, max(0, n - vd.shape[1])))[:, :n]
    acc = torch.zeros_like(x, memory_format=torch.contiguous_format)
    for j, d in enumerate(offs):
        if d >= n:
            continue
        v = vd[j, d:, None]  # v_j at rows g = d .. n-1
        acc[d:] += v * x[: n - d]  # row side: y[g] += v_j[g] x[g - d]
        acc[: n - d] += v * x[d:]  # transpose: y[g - d] += v_j[g] x[g]
    return acc


def sdia_sym_rows_df_mm(vals, x, offsets):
    """``Y = (L + D + Lᵀ) X`` in float64 for X (n, B) in the caller's
    row-major layout, returned as a fresh contiguous (n, B) Y.

    ``vals``: (R, D, 8, 128) float64, the offset-0 plane (if any) holding
    half the main diagonal; ``x``: as :func:`rows_x` takes it (B even,
    contiguous, rows 16-byte aligned), the n rows of the square matrix,
    read as zero outside them; ``offsets``: (D,) int32, each ``>= 0``.

    A CPU tensor takes the plain twin; a CUDA tensor launches
    ``sdia_sym_rows_kernel`` once per group of up to ``_cuda.RHS_GROUP``
    columns (building it on first use) or raises."""
    sk._check_vals(vals, offsets, torch.float64)
    if not rows_x(x):
        raise ValueError("x must be a contiguous (n, B) float64 tensor of "
                         "even B with 16-byte aligned rows")
    if x.device != vals.device:
        raise ValueError("all operands must live on one device")
    if vals.device.type == "cpu":
        return sdia_sym_rows_plain(vals, x, offsets)
    y = torch.empty_like(x)
    # the columns as (B, n) views: launch_groups steps a group's first
    # column by the 8-byte column stride; the kernel reads rows at stride B
    sdia_sym_rows_df_mm.launches += _cuda.launch_groups(
        "sdia_sym_rows_df_mm", x.T, y.T, functools.partial(
            _cuda.lib().cfs_sdia_sym_rows_f64, vals.data_ptr(),
            offsets.data_ptr(), vals.shape[1], vals.shape[0] * sk.BLOCK_ROWS,
            x.shape[0], x.shape[1]))
    return y


#: launches of the CUDA kernel through these wrappers (never the twins)
sdia_sym_tiles_df.launches = 0
sdia_sym_tiles_df_mm.launches = 0
sdia_sym_rows_df_mm.launches = 0
