"""SDIA — dense-diagonal SpMV and SpMM: CUDA kernel wrappers + plain twins.

Ports of ``cfs_spmv_tpu/ops/sdia_kernel.py``:

- ``sdia_sym_tiles`` (kernel B1): symmetric strict-lower diagonals,
  each value feeding both ``y[g] += v * x[g - d]`` (row side) and
  ``y[g - d] += v * x[g]`` (transpose side);
- ``sdia_gen_tiles`` (kernel B6): signed offsets, row side only — the
  general path's peeled diagonals, and symmetric plans past
  ``SDIA_SYM_ROWS_MAX`` whose diagonals are stored mirrored;
- ``sdia_sym_tiles_mm`` (B11) and ``sdia_gen_tiles_mm`` (B12): the same
  for B right-hand sides, X as (B, x_rows, 128) planes (B12's kernel
  reads it interleaved, as B7's does: ``bell2_kernel.interleave_x``, or
  an (m, B) X in place, :func:`gen_x`) and Y as (B, T, 128) planes; each
  launch reads the values once for up to ``_cuda.RHS_GROUP`` planes.

The float64 forms of B1 and B11 (``sdia_sym_tiles_df``, B13, and
``sdia_sym_tiles_df_mm``, B14) live in ``ops/sdia_df.py``; they share the
checks, the launcher and the twins of this module, which work in the
stream's type. B6 and B12 take float64 values with float64 x and y
themselves (the float64 ``DistSpDMV``'s mirrored diagonals): their
kernel's double instance, counted in ``launches_f64``; given the plan's
``window`` (:func:`gen_window`, decided at upload: offsets that span
little, as a banded shard's mirrored ones do) it first stages each CTA's
window of X in shared memory and reads every diagonal's x there.

Diagonals dense enough to store contiguously need no index data at all:
per stored nonzero the stream moves 4 bytes (8 in float64, 2 for the
bfloat16 values of ``values="bfloat16"``, which the wrappers take beside
float32 x and y: the kernels widen each value as they load it, the twins
compute on ``vals.float()``). Layout:
``vals[r, j, i, l]`` holds A[g, g - d_j] for flat row g = 1024 r + 128 i
+ l (zero where absent). The signed kernel (``csrc/spmv_kernels.cu``)
runs 1 or 2 threads a row (:func:`gen_slices`, from the rows and D),
no atomics, and has a store form that writes y instead of adding to it
(for an applier that would pass zeroed tiles). The symmetric one splits
each row's diagonals between two threads of a CTA, which gathers both
sides of its rows, and over planes, given ``stage_x`` (the upload's
:func:`stages_x`: most offsets small), first stages the x rows near its
own in shared memory; no atomics either. What it sums is the twin's terms
in another order, whatever ``stage_x`` says.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda
from . import bell2_kernel as bk

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
    "gen_slices",
    "gen_x",
    "BLOCK_ROWS",
    "SDIA_HALO",
    "stages_x",
    "GEN_SPAN",
    "gen_window",
    "stage_slices",
]

#: threads one NVIDIA H100 SXM keeps resident (132 SMs x 2048): the
#: default of :func:`gen_slices` (the launcher asks the device)
H100_THREAD_SLOTS = 132 * 2048

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


#: ``kGenSpan`` of ``csrc/spmv_kernels.cu``: the widest spread of signed
#: offsets whose x window the double signed diagonal kernel stages
GEN_SPAN = 128


def gen_window(offsets):
    """``(hi, span)`` of signed ``offsets`` whose x window the double
    signed diagonal kernel stages: the largest offset and the largest less
    the smallest, where that span is at most :data:`GEN_SPAN` (a banded
    shard's mirrored diagonals: cant's +-1..32 span 64); else None
    (``general_asym()``'s +-6,400). A CTA of rows [r0, r0 + n) then reads
    x rows [r0 - hi, r0 + n + span - hi). Decided once a plan, at
    upload."""
    offs = [int(d) for d in offsets]
    if not offs or max(offs) - min(offs) > GEN_SPAN:
        return None
    return max(offs), max(offs) - min(offs)


def stage_slices(rows: int, D: int, slots: int = H100_THREAD_SLOTS) -> int:
    """Threads a row of the staged double signed diagonal kernel (each
    takes every ``slices``-th diagonal): 4 or 2 where that many a row fit
    the card's ``slots`` at once and leave each thread 4 diagonals or
    more, else 1. On D1's mirrored shard (16,384 rows, 64 diagonals) 4
    slices ran faster than 1, 2 and 8 (PERF.md §6); the launcher also
    takes 8, which ``chip_smoke.py`` times beside them."""
    for s in (4, 2):
        if rows * s <= slots and D >= 4 * s:
            return s
    return 1


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
    """The values and offsets of a stream whose x and y are ``dtype``
    (bfloat16 values with float32 x and y)."""
    if vals.ndim != 4 or tuple(vals.shape[2:]) != (SUBLANES, LANES):
        raise ValueError(f"vals must be (R, D, 8, 128), got {tuple(vals.shape)}")
    _cuda.check_values(vals, "vals", dtype)
    if offsets.shape != (vals.shape[1],) or offsets.dtype != torch.int32:
        raise ValueError("offsets must be an int32 tensor of length D")
    for t in (vals, offsets):
        if t.device != vals.device:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vals.device}")


def _check(vals, x2d, y_tiles, offsets, dtype=torch.float32, flat_x=False):
    """Operands of one SpMV call of a stream whose x and y are ``dtype``
    and whose values are too (or bfloat16, for float32); another mix
    raises ``TypeError``. ``flat_x``: x may also be an (m,) vector, read
    as zero past m."""
    _check_vals(vals, offsets, dtype)
    if not (flat_x and x2d.ndim == 1) and (x2d.ndim != 2
                                           or x2d.shape[1] != LANES):
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
    slices, one pair per diagonal, in the type of y (float32 or float64;
    bfloat16 values are widened first). Accumulates in place and returns
    ``y_tiles``. Runs on any device; ``offsets`` is a tensor or a
    sequence of ints ``>= 0`` (an offset 0 adds its values twice: the
    float64 route stores the main diagonal halved)."""
    offs = offsets.tolist() if torch.is_tensor(offsets) else list(offsets)
    vals = vals.to(y_tiles.dtype)
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

    ``vals``: (R, D, 8, 128) float32 or bfloat16; ``x2d``: (x_rows, 128)
    float32, read as zero beyond its end; ``y_tiles``: (T, 128) float32,
    accumulated in place (the reference aliases it) and returned;
    ``offsets``: (D,) int32 lower diagonal offsets, on the same device
    (all ``>= 1`` in the fp32 plans; the kernel also takes 0, which the
    float64 route stores with halved values, see ``ops/sdia_df.py``).
    Contributions to rows at or past T*128 are dropped, as in the
    reference.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    _check(vals, x2d, y_tiles, offsets)
    if vals.device.type == "cpu":
        return sdia_sym_tiles_plain(vals, x2d, y_tiles, offsets)
    _cuda.count(sdia_sym_tiles, vals.dtype, _launch_sym(
        vals, x2d[None], y_tiles[None], offsets, "sdia_sym_tiles"))
    return y_tiles


def _launch_sym(vals, x3d, y3d, offsets, name, stage_x=False):
    fn = _cuda.entry("sdia_sym", vals.dtype)
    return _cuda.launch_groups(name, x3d, y3d, functools.partial(
        fn, vals.data_ptr(), offsets.data_ptr(), vals.shape[1],
        vals.shape[0] * BLOCK_ROWS, x3d[0].numel(), y3d[0].numel(),
        int(stage_x)))


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
    _cuda.count(sdia_sym_tiles_mm, vals.dtype, _launch_sym(
        vals, x3d, y_tiles, offsets, "sdia_sym_tiles_mm", stage_x))
    return y_tiles


def sdia_gen_tiles_plain(vals, x2d, y_tiles, offsets, store=False,
                         window=None):
    """Plain PyTorch twin of :func:`sdia_gen_tiles`: ``y_tiles += A_dia
    x`` by one flat shifted slice per diagonal, accumulated in place (with
    ``store``, into zeroed tiles); returns ``y_tiles``. Runs on any device;
    ``x2d`` is read flat (any shape), ``offsets`` is a tensor or a sequence
    of ints; ``window`` changes nothing here."""
    offs = offsets.tolist() if torch.is_tensor(offsets) else list(offsets)
    vals = vals.to(y_tiles.dtype)
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
    if store:
        y_tiles.zero_()
    y_tiles.view(-1)[:L] += acc
    return y_tiles


def sdia_gen_tiles(vals, x2d, y_tiles, offsets, store=False, window=None):
    """``y_tiles += A_dia x`` for the signed-offset dense-diagonal stream.

    ``vals``: (R, D, 8, 128) float32 or bfloat16, or float64; ``x2d``:
    (x_rows, 128), or x itself as an (m,) vector, read as zero outside it
    (``d > 0`` reads behind, ``d < 0`` ahead), float32 (float64 for
    float64 values); ``y_tiles``: (T, 128) of x's type, accumulated in
    place and returned;
    ``offsets``: (D,) int32 signed offsets (``d == 0`` allowed), on the
    same device. Contributions to rows at or past T*128 are dropped, and
    rows past R*1024 keep their value, as in the reference. ``store``
    (for an applier that would pass zeroed tiles): ``y_tiles`` is written,
    not read, and its rows past R*1024 come out exact 0. ``window`` (the
    plan's :func:`gen_window`) stages x in the double kernel; float32 and
    bfloat16 values ignore it.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it on first use) or raises.
    """
    _check(vals, x2d, y_tiles, offsets, _cuda.xy_dtype(vals), flat_x=True)
    if vals.device.type == "cpu":
        return sdia_gen_tiles_plain(vals, x2d, y_tiles, offsets, store)
    _cuda.count(sdia_gen_tiles, vals.dtype, _launch_gen(
        vals, x2d.reshape(1, -1), y_tiles[None], offsets, "sdia_gen_tiles",
        store, window=window), f64_apart=True)
    return y_tiles


def gen_slices(rows: int, D: int, slots: int = H100_THREAD_SLOTS) -> int:
    """Threads of the signed diagonal kernel a row (each takes every
    other diagonal): 2 where ``rows * 2`` threads fit the card's ``slots``
    (threads resident at once) and there are two diagonals to share, as
    on the 62-65k-row plans; else 1, as on ``general_asym()``'s 512,000
    rows, which fill the card alone."""
    return 2 if rows * 2 <= slots and D >= 2 else 1


def _thread_slots(device) -> int:
    """Threads ``device`` keeps resident at once (SMs x threads an SM)."""
    p = torch.cuda.get_device_properties(device)
    return p.multi_processor_count * getattr(
        p, "max_threads_per_multi_processor", 2048)


def _launch_gen(vals, x_il, y3d, offsets, name, store=False, slices=None,
                window=None):
    """Launch the signed diagonal kernel over the planes ``y3d``, once a
    group of planes; returns the launches. ``x_il`` is an interleaved X
    (``bell2_kernel.interleave_x``: a plane, or a group's planes side by
    side, group after group), each plane read as zero past its
    ``x_il.shape[1]`` elements; ``window`` (:func:`gen_window`, read for
    float64 values only) stages x; ``slices`` (default :func:`gen_slices`,
    staged :func:`stage_slices`, of the rows and D on this device) as the
    launcher takes it."""
    nv_rows, y_len = vals.shape[0] * BLOCK_ROWS, y3d[0].numel()
    hi, span = (window if window is not None
                and vals.dtype == torch.float64 else (0, -1))
    if slices is None:
        rows = y_len if store else min(y_len, nv_rows)
        rule = stage_slices if span >= 0 else gen_slices
        slices = rule(rows, vals.shape[1], _thread_slots(vals.device))
    fn = _cuda.entry("sdia_gen", vals.dtype)
    return _cuda.launch_groups(name, x_il, y3d, functools.partial(
        fn, vals.data_ptr(), offsets.data_ptr(), vals.shape[1], nv_rows,
        y_len, x_il.shape[1], slices, int(store), hi, span))


def gen_x(x, x_rows):
    """The X :func:`sdia_gen_tiles_mm` reads (with ``planes`` = B) for
    the (m, B) float32 or float64 X of an SpMM apply: X itself, as a (B, m)
    view, where it is an interleaved X of one group already (B of 1, 2, 4
    or 8, contiguous, 32-byte aligned), read in place with x_len = m; else
    ``bell2_kernel.interleave_x``'s copy, x_rows * 128 rows long."""
    m, B = x.shape
    if (B in (1, 2, 4, 8) and x.dtype in (torch.float32, torch.float64)
            and x.is_contiguous() and x.data_ptr() % 32 == 0):
        return x.view(B, m)
    return bk.interleave_x(x, x_rows)


def sdia_gen_tiles_mm_plain(vals, x3d, y_tiles, offsets, *, planes=None,
                            store=False, window=None):
    """Plain PyTorch twin of :func:`sdia_gen_tiles_mm`: B6's twin once
    per plane (of the interleaved X's planes, given ``planes``),
    accumulated in place; returns ``y_tiles``. ``window`` changes nothing
    here."""
    if planes is not None:
        x3d = bk.flat_planes(x3d, planes)
    for b in range(x3d.shape[0]):
        sdia_gen_tiles_plain(vals, x3d[b], y_tiles[b], offsets, store)
    return y_tiles


def sdia_gen_tiles_mm(vals, x3d, y_tiles, offsets, *, planes=None,
                      store=False, window=None):
    """``Y_tiles += A_dia X`` for B right-hand sides: ``x3d`` (B, x_rows,
    128) planes of x's type (float32; float64 for float64 values), each
    contiguous (any plane stride), which the wrapper interleaves for the
    kernel (one copy); or, given ``planes`` = B, X already interleaved:
    :func:`bell2_kernel.interleave_x`'s copy, or :func:`gen_x`'s view of
    an (m, B) X read in place (any row count; x is zero past it).
    ``y_tiles`` (B, T, 128), planes each contiguous, is accumulated in
    place (written, with ``store``) and returned. Otherwise as
    :func:`sdia_gen_tiles`, plane by plane (``window`` too). A CUDA tensor
    launches once per group of up to ``_cuda.RHS_GROUP`` planes; a CPU
    tensor takes the plain twin."""
    dtype = _cuda.xy_dtype(vals)
    _check_vals(vals, offsets, dtype)
    if planes is None:
        B = _cuda.check_planes(x3d, "x3d", vals.device, dtype)
    else:
        B = bk.check_interleaved(x3d, vals.device, planes, padded=False,
                                 dtype=dtype)
    _cuda.check_planes(y_tiles, "y_tiles", vals.device, dtype, B=B)
    if vals.device.type == "cpu":
        return sdia_gen_tiles_mm_plain(vals, x3d, y_tiles, offsets,
                                       planes=planes, store=store)
    if planes is None:
        x3d = (x3d[0].reshape(1, -1) if B == 1 else
               bk.interleave_x(x3d.reshape(B, -1).T, x3d.shape[1]))
    _cuda.count(sdia_gen_tiles_mm, vals.dtype, _launch_gen(
        vals, x3d, y_tiles, offsets, "sdia_gen_tiles_mm", store,
        window=window), f64_apart=True)
    return y_tiles


#: launches of the CUDA kernels through these wrappers (never the twins):
#: ``launches`` of the float32 instances, ``launches_bf16`` of the bf16 ones
#: and, for the signed diagonal kernel, ``launches_f64`` of the double ones
for _w in (sdia_sym_tiles, sdia_gen_tiles, sdia_sym_tiles_mm,
           sdia_gen_tiles_mm):
    _w.launches = _w.launches_bf16 = 0
sdia_gen_tiles.launches_f64 = sdia_gen_tiles_mm.launches_f64 = 0
del _w
