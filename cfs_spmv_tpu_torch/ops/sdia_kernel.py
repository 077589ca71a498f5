"""SDIA — dense-diagonal symmetric SpMV: CUDA kernel wrapper + plain twin.

Port of ``cfs_spmv_tpu/ops/sdia_kernel.py:sdia_sym_tiles`` (kernel B1).
Diagonals dense enough to store contiguously need no index data at all:
per stored nonzero the stream moves 4 bytes, and each value feeds both
``y[g] += v * x[g - d]`` (row side) and ``y[g - d] += v * x[g]``
(transpose side).

Layout: ``vals[r, j, i, l]`` holds A[g, g - d_j] for flat row
g = 1024 r + 128 i + l (zero where absent), with strict-lower offsets
``d_j >= 1``. The CUDA kernel (``csrc/spmv_kernels.cu:sdia_sym_kernel``)
computes the gather form: one thread per output row, no atomics.
"""

from __future__ import annotations

import torch

from . import _cuda

SUBLANES = 8
LANES = 128
BLOCK_ROWS = SUBLANES * LANES  # 1024 rows per value block

__all__ = ["sdia_sym_tiles", "sdia_sym_tiles_plain", "BLOCK_ROWS"]


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


def _check(vals, x2d, y_tiles, offsets):
    if vals.ndim != 4 or tuple(vals.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"vals must be (R, D, 8, 128), got {tuple(vals.shape)}")
    if x2d.ndim != 2 or x2d.shape[1] != LANES:
        raise ValueError(f"x2d must be (x_rows, 128), got {tuple(x2d.shape)}")
    if y_tiles.ndim != 2 or y_tiles.shape[1] != LANES:
        raise ValueError(
            f"y_tiles must be (T, 128), got {tuple(y_tiles.shape)}"
        )
    if offsets.shape != (vals.shape[1],) or offsets.dtype != torch.int32:
        raise ValueError("offsets must be an int32 tensor of length D")
    for name, t in (("vals", vals), ("x2d", x2d), ("y_tiles", y_tiles)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for t in (vals, x2d, y_tiles, offsets):
        if t.device != vals.device:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets):
    """Plain PyTorch twin: ``y_tiles += (L + Lᵀ) x`` by flat shifted
    slices, one pair per diagonal. Accumulates in place and returns
    ``y_tiles``. Runs on any device; ``offsets`` is a tensor or a
    sequence of ints."""
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
    strict-lower diagonal offsets, on the same device. Contributions to
    rows at or past T*128 are dropped, as in the reference.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    _check(vals, x2d, y_tiles, offsets)
    dev = vals.device
    if dev.type == "cpu":
        return sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets)
    if dev.type != "cuda":
        raise ValueError(f"sdia_sym_tiles: unsupported device {dev}")
    lib = _cuda.lib()
    with torch.cuda.device(dev):
        err = lib.cfs_sdia_sym(
            vals.data_ptr(), offsets.data_ptr(), vals.shape[1],
            vals.shape[0] * BLOCK_ROWS, x2d.data_ptr(), x2d.numel(),
            y_tiles.data_ptr(), y_tiles.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(err, "sdia_sym_tiles")
    sdia_sym_tiles.launches += 1
    return y_tiles


#: launches of the CUDA kernel through this wrapper (never the twin)
sdia_sym_tiles.launches = 0
