"""SDIA — dense-diagonal SpMV and SpMM: CUDA kernel wrappers + plain twins.

Ports of ``cfs_spmv_tpu/ops/sdia_kernel.py``:

- ``sdia_sym_tiles`` (kernel B1): symmetric strict-lower diagonals,
  each value feeding both ``y[g] += v * x[g - d]`` (row side) and
  ``y[g - d] += v * x[g]`` (transpose side);
- ``sdia_gen_tiles`` (kernel B6): signed offsets, row side only — the
  general path's peeled diagonals, and symmetric plans past
  ``SDIA_SYM_ROWS_MAX`` whose diagonals are stored mirrored;
- ``sdia_sym_tiles_mm`` (B11) and ``sdia_gen_tiles_mm`` (B12): the same
  for B right-hand sides, X as (B, x_rows, 128) and Y as (B, T, 128)
  planes; each launch reads the values once for up to
  ``_cuda.RHS_GROUP`` planes.

The float64 forms of B1 and B11 (``sdia_sym_tiles_df``, B13, and
``sdia_sym_tiles_df_mm``, B14) live in ``ops/sdia_df.py``; they share the
checks, the launcher and the twins of this module, which work in the
stream's type.

Diagonals dense enough to store contiguously need no index data at all:
per stored nonzero the stream moves 4 bytes (8 in float64). Layout:
``vals[r, j, i, l]`` holds A[g, g - d_j] for flat row g = 1024 r + 128 i
+ l (zero where absent). The signed kernel (``csrc/spmv_kernels.cu``)
runs one thread per output row, no atomics. The symmetric one splits
each row's diagonals between two threads of a CTA, which gathers both
sides of its rows, and over planes, given ``stage_x`` (the upload's
:func:`stages_x`: most offsets small), first stages the x rows near its
own in shared memory; no atomics either. What it sums is the twin's terms
in another order, whatever ``stage_x`` says.
"""

from __future__ import annotations

import torch

from . import _cuda

SUBLANES = 8
LANES = 128
BLOCK_ROWS = SUBLANES * LANES  # 1024 rows per value block

__all__ = [
    "sdia_sym_tiles",
    "sdia_sym_tiles_plain",
    "sdia_sym_tiles_mm",
    "sdia_sym_tiles_mm_plain",
    "sdia_gen_tiles",
    "sdia_gen_tiles_plain",
    "sdia_gen_tiles_mm",
    "sdia_gen_tiles_mm_plain",
    "BLOCK_ROWS",
    "SDIA_HALO",
    "stages_x",
]

#: ``kSdiaHalo`` of ``csrc/spmv_kernels.cu``: over planes the symmetric
#: kernel may stage the x rows this close to a CTA's own rows
SDIA_HALO = 64


def stages_x(offsets) -> bool:
    """Whether the symmetric kernel stages x over planes for these lower
    ``offsets``: where at least half lie within :data:`SDIA_HALO` (cant,
    the flagship; not stencil27, 4 of whose 13 do). Decided once a plan,
    at upload."""
    offs = [int(d) for d in offsets]
    return bool(offs) and 2 * sum(d <= SDIA_HALO for d in offs) >= len(offs)


def _blocks_per_step(R: int, D: int, itemsize: int = 4) -> int:
    """Row blocks per grid step of the reference's TPU kernel (a fixed
    byte budget of vals per step, cap 8).

    Kept identical to the reference (``cfs_spmv_tpu/ops/sdia_kernel.py``):
    the planner (``formats/sdia.sdia_shell``) pads every SDIA plan's R to
    this multiple, so the port's plans stay byte-identical to the
    reference's. Must give the same answer for the plan's original R and
    the padded R (= next multiple): min(cap, R) with cap independent of
    R — and independent of the storage dtype (itemsize is pinned to 4 by
    the callers so bf16-cast plans keep their geometry).
    """
    per_block = D * SUBLANES * LANES * itemsize
    cap = max(1, min(SUBLANES, (512 * 1024) // max(per_block, 1)))
    return min(cap, R)


def _check_vals(vals, offsets, dtype):
    if vals.ndim != 4 or tuple(vals.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"vals must be (R, D, 8, 128), got {tuple(vals.shape)}")
    if vals.dtype != dtype:
        raise TypeError(f"vals must be {dtype}, got {vals.dtype}")
    if offsets.shape != (vals.shape[1],) or offsets.dtype != torch.int32:
        raise ValueError("offsets must be an int32 tensor of length D")
    for t in (vals, offsets):
        if t.device != vals.device:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")


def _check(vals, x2d, y_tiles, offsets, dtype=torch.float32):
    """Operands of one SpMV call of a stream whose values, x and y are
    all ``dtype``; a mix raises ``TypeError``."""
    _check_vals(vals, offsets, dtype)
    if x2d.ndim != 2 or x2d.shape[1] != LANES:
        raise ValueError(f"x2d must be (x_rows, 128), got {tuple(x2d.shape)}")
    if y_tiles.ndim != 2 or y_tiles.shape[1] != LANES:
        raise ValueError(
            f"y_tiles must be (T, 128), got {tuple(y_tiles.shape)}"
        )
    for name, t in (("x2d", x2d), ("y_tiles", y_tiles)):
        _cuda.check_dtype(t, name, dtype)
        if t.device != vals.device:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_mm(vals, x3d, y_tiles, offsets, dtype=torch.float32):
    """X (B, x_rows, 128) and Y (B, T, 128): planes each contiguous, of
    the stream's ``dtype``."""
    _check_vals(vals, offsets, dtype)
    B = _cuda.check_planes(x3d, "x3d", vals.device, dtype)
    _cuda.check_planes(y_tiles, "y_tiles", vals.device, dtype, B=B)


def sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets):
    """Plain PyTorch twin: ``y_tiles += (L + Lᵀ) x`` by flat shifted
    slices, one pair per diagonal, in the operands' type (float32 or
    float64). Accumulates in place and returns ``y_tiles``. Runs on any
    device; ``offsets`` is a tensor or a sequence of ints ``>= 0`` (an
    offset 0 adds its values twice: the float64 route stores the main
    diagonal halved)."""
    offs = offsets.tolist() if torch.is_tensor(offsets) else list(offsets)
    R, D = vals.shape[0], vals.shape[1]
    N = R * BLOCK_ROWS
    xf = x2d.reshape(-1)[:N]
    if xf.shape[0] < N:
        xf = torch.nn.functional.pad(xf, (0, N - xf.shape[0]))
    vd = vals.permute(1, 0, 2, 3).reshape(D, N)  # diagonal j, flat row g
    acc = torch.zeros(N, dtype=y_tiles.dtype, device=y_tiles.device)
    for j, d in enumerate(offs):
        if d >= N:
            continue
        v = vd[j, d:]  # v_j at rows g = d .. N-1
        acc[d:] += v * xf[: N - d]  # row side: y[g] += v_j[g] x[g - d]
        acc[: N - d] += v * xf[d:]  # transpose: y[g - d] += v_j[g] x[g]
    L = min(y_tiles.numel(), N)
    y_tiles.view(-1)[:L] += acc[:L]
    return y_tiles


def sdia_sym_tiles(vals, x2d, y_tiles, offsets):
    """``y_tiles += (L + Lᵀ) x`` for the dense-diagonal symmetric stream.

    ``vals``: (R, D, 8, 128) float32; ``x2d``: (x_rows, 128) float32, read
    as zero beyond its end; ``y_tiles``: (T, 128) float32, accumulated in
    place (the reference aliases it) and returned; ``offsets``: (D,) int32
    lower diagonal offsets, on the same device (all ``>= 1`` in the fp32
    plans; the kernel also takes 0, which the float64 route stores with
    halved values, see ``ops/sdia_df.py``). Contributions to
    rows at or past T*128 are dropped, as in the reference.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    _check(vals, x2d, y_tiles, offsets)
    if vals.device.type == "cpu":
        return sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets)
    sdia_sym_tiles.launches += _launch_sym(vals, x2d[None], y_tiles[None],
                                           offsets, "sdia_sym_tiles")
    return y_tiles


def _launch_sym(vals, x3d, y3d, offsets, name, stage_x=False):
    fn = _cuda.entry("sdia_sym", vals.dtype)
    return _cuda.launch_groups(
        name, x3d, y3d, lambda *planes: fn(
            vals.data_ptr(), offsets.data_ptr(), vals.shape[1],
            vals.shape[0] * BLOCK_ROWS, x3d[0].numel(), y3d[0].numel(),
            int(stage_x), *planes,
        ))


def sdia_sym_tiles_mm_plain(vals, x3d, y_tiles, offsets, stage_x=False):
    """Plain PyTorch twin of :func:`sdia_sym_tiles_mm`: B1's twin once
    per plane, accumulated in place; returns ``y_tiles``. ``stage_x``
    changes nothing here."""
    for b in range(x3d.shape[0]):
        sdia_sym_tiles_plain(vals, x3d[b], y_tiles[b], offsets)
    return y_tiles


def sdia_sym_tiles_mm(vals, x3d, y_tiles, offsets, stage_x=False):
    """``Y_tiles += (L + Lᵀ) X`` for B right-hand sides: ``x3d`` (B,
    x_rows, 128) and ``y_tiles`` (B, T, 128) float32 stacks whose planes
    are each contiguous (any plane stride); ``y_tiles`` is accumulated
    in place and returned. Otherwise as :func:`sdia_sym_tiles`, plane by
    plane. ``stage_x`` (the upload's ``dia_stage_x``) has a group of two
    planes or more stage its CTA's x rows within :data:`SDIA_HALO` in
    shared memory; the result is the same either way. A CUDA tensor
    launches once per group of up to ``_cuda.RHS_GROUP`` planes; a CPU
    tensor takes the plain twin."""
    _check_mm(vals, x3d, y_tiles, offsets)
    if vals.device.type == "cpu":
        return sdia_sym_tiles_mm_plain(vals, x3d, y_tiles, offsets)
    sdia_sym_tiles_mm.launches += _launch_sym(vals, x3d, y_tiles, offsets,
                                              "sdia_sym_tiles_mm", stage_x)
    return y_tiles


def sdia_gen_tiles_plain(vals, x2d, y_tiles, offsets):
    """Plain PyTorch twin of :func:`sdia_gen_tiles`: ``y_tiles += A_dia
    x`` by one flat shifted slice per diagonal, accumulated in place;
    returns ``y_tiles``. Runs on any device; ``offsets`` is a tensor or a
    sequence of ints."""
    offs = offsets.tolist() if torch.is_tensor(offsets) else list(offsets)
    R, D = vals.shape[0], vals.shape[1]
    L = min(y_tiles.numel(), R * BLOCK_ROWS)
    xf = x2d.reshape(-1)
    X = xf.shape[0]
    vd = vals.permute(1, 0, 2, 3).reshape(D, R * BLOCK_ROWS)
    acc = torch.zeros(L, dtype=y_tiles.dtype, device=y_tiles.device)
    for j, d in enumerate(offs):
        # rows g with 0 <= g - d < X read x; the others read zero
        lo, hi = max(0, d), min(L, X + d)
        if lo < hi:
            acc[lo:hi] += vd[j, lo:hi] * xf[lo - d: hi - d]
    y_tiles.view(-1)[:L] += acc
    return y_tiles


def sdia_gen_tiles(vals, x2d, y_tiles, offsets):
    """``y_tiles += A_dia x`` for the signed-offset dense-diagonal stream.

    ``vals``: (R, D, 8, 128) float32; ``x2d``: (x_rows, 128) float32,
    read as zero outside it (``d > 0`` reads behind, ``d < 0`` ahead);
    ``y_tiles``: (T, 128) float32, accumulated in place and returned;
    ``offsets``: (D,) int32 signed offsets (``d == 0`` allowed), on the
    same device. Contributions to rows at or past T*128 are dropped, and
    rows past R*1024 keep their value, as in the reference.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    _check(vals, x2d, y_tiles, offsets)
    if vals.device.type == "cpu":
        return sdia_gen_tiles_plain(vals, x2d, y_tiles, offsets)
    sdia_gen_tiles.launches += _launch_gen(vals, x2d[None], y_tiles[None],
                                           offsets, "sdia_gen_tiles")
    return y_tiles


def _launch_gen(vals, x3d, y3d, offsets, name):
    lib = _cuda.lib()
    n_rows = min(y3d[0].numel(), vals.shape[0] * BLOCK_ROWS)
    return _cuda.launch_groups(
        name, x3d, y3d, lambda *planes: lib.cfs_sdia_gen(
            vals.data_ptr(), offsets.data_ptr(), vals.shape[1], n_rows,
            x3d[0].numel(), *planes,
        ))


def sdia_gen_tiles_mm_plain(vals, x3d, y_tiles, offsets):
    """Plain PyTorch twin of :func:`sdia_gen_tiles_mm`: B6's twin once
    per plane, accumulated in place; returns ``y_tiles``."""
    for b in range(x3d.shape[0]):
        sdia_gen_tiles_plain(vals, x3d[b], y_tiles[b], offsets)
    return y_tiles


def sdia_gen_tiles_mm(vals, x3d, y_tiles, offsets):
    """``Y_tiles += A_dia X`` for B right-hand sides: ``x3d`` (B, x_rows,
    128) and ``y_tiles`` (B, T, 128) float32 stacks whose planes are each
    contiguous (any plane stride); ``y_tiles`` is accumulated in place and
    returned. Otherwise as :func:`sdia_gen_tiles`, plane by plane. A CUDA
    tensor launches once per group of up to ``_cuda.RHS_GROUP`` planes; a
    CPU tensor takes the plain twin."""
    _check_mm(vals, x3d, y_tiles, offsets)
    if vals.device.type == "cpu":
        return sdia_gen_tiles_mm_plain(vals, x3d, y_tiles, offsets)
    sdia_gen_tiles_mm.launches += _launch_gen(vals, x3d, y_tiles, offsets,
                                              "sdia_gen_tiles_mm")
    return y_tiles


#: launches of the CUDA kernels through these wrappers (never the twins)
sdia_sym_tiles.launches = 0
sdia_gen_tiles.launches = 0
sdia_sym_tiles_mm.launches = 0
sdia_gen_tiles_mm.launches = 0
