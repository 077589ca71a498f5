"""SDIA plan — dense-diagonal extraction for symmetric matrices.

Host copy of ``cfs_spmv_tpu/formats/sdia.py``, code unchanged (plans held
byte-identical by ``tests/test_torch_formats.py``); its thresholds were
derived from the reference's TPU kernels, whose measurements the
reference file keeps.

Host-side companion of ``ops/sdia_kernel.py``: finds the strict-lower
exact diagonals dense enough to pay for contiguous (index-free) storage
and lays their values out as (R, D, 8, 128) row blocks. The remaining
entries stay on the indexed SBELL/far streams — the same
structure-driven decomposition idea as the reference's bandwidth split
(``csr_matrix.tpp:313-401``), keyed on diagonal fill instead of span.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.logging import info
from .bell2 import LANES, SUBLANES

__all__ = ["SDiaPlan", "extract_sdia", "SDIA_FILL", "SDIA_MIN_COUNT"]

#: minimum fill (entries / diagonal length) for dense storage: the
#: crossover against the slot-packed far stream, with a safety margin
SDIA_FILL = 0.2
#: absolute minimum entries per diagonal (avoids trace bloat on tiny
#: dense-ish diagonals)
SDIA_MIN_COUNT = 256
#: maximum number of stored diagonals (the reference kernel's block and
#: trace size cap)
SDIA_MAX_D = 192

#: above this row count the reference's symmetric kernel no longer
#: holds x and y whole in its fast memory; diagonals are then stored
#: MIRRORED (2x values) and run on the blocked-y one-sided kernel
#: instead (env CFS_SDIA_SYM_ROWS_MAX)
import os as _os

SDIA_SYM_ROWS_MAX = int(
    _os.environ.get("CFS_SDIA_SYM_ROWS_MAX", 10_000_000)
)

BLOCK_ROWS = SUBLANES * LANES


@dataclasses.dataclass
class SDiaPlan:
    nrows: int
    #: diagonal offsets d = row - col. All positive (strict lower) for
    #: the paired symmetric kernel; signed for the one-sided/general
    #: kernel (``sdia_gen_tiles``) — any negative offset present means
    #: the plan targets the blocked-y one-sided kernel
    offsets: tuple[int, ...]
    vals: np.ndarray  # (R, D, 8, 128)
    nnz: int  # stored entries

    @property
    def num_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padding_ratio(self) -> float:
        return self.vals.size / max(self.nnz, 1)

    def stream_bytes(self) -> int:
        return self.vals.nbytes


def select_offsets(uniq, cnt, n, *, fill, min_count, max_d, mirror,
                   signed, include_zero=False):
    """Dense-diagonal selection shared by the NumPy and native
    extraction paths: offsets whose count clears both the absolute and
    the fill-fraction threshold, heaviest-first truncated to the plane
    budget. Returns the selected offsets or None. ``include_zero``
    admits the main diagonal into a paired-symmetric plan (the caller
    halves its values so row + transpose sides sum to the full term —
    the double-float path, ``ops/sdia_df``)."""
    length = np.maximum(n - np.abs(uniq), 1)
    ok = (cnt >= min_count) & (cnt >= fill * length)
    if not signed and not mirror:
        ok &= (uniq >= 0) if include_zero else (uniq > 0)
    if ok.sum() > max_d // (2 if mirror else 1):
        # keep the heaviest diagonals
        order = np.argsort(cnt[ok])[::-1][: max_d // (2 if mirror else 1)]
        keep_ids = np.flatnonzero(ok)[order]
        ok = np.zeros_like(ok)
        ok[keep_ids] = True
    if not ok.any():
        return None
    return uniq[ok]


def sdia_shell(n, offsets, mirror, dtype):
    """Zeroed (R, D, 8, 128) value planes + geometry for a selected
    diagonal set (R padded to the kernel's blocks-per-step)."""
    from ..ops.sdia_kernel import _blocks_per_step

    R = -(-n // BLOCK_ROWS)
    D0 = len(offsets)
    D = 2 * D0 if mirror else D0
    RB = _blocks_per_step(R, D)
    R = -(-R // RB) * RB
    vals = np.zeros((R, D, SUBLANES, LANES), dtype)
    if mirror:
        all_offsets = tuple(int(d) for d in offsets) + tuple(
            -int(d) for d in offsets
        )
    else:
        all_offsets = tuple(int(d) for d in offsets)
    return vals, D, D0, all_offsets


def extract_sdia(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    n: int,
    *,
    dtype=np.float32,
    fill: float = SDIA_FILL,
    min_count: int = SDIA_MIN_COUNT,
    max_d: int = SDIA_MAX_D,
    mirror: bool = False,
    signed: bool = False,
    min_frac: float = 0.0,
    include_zero: bool = False,
):
    """Split COO entries into (SDiaPlan | None, residual mask).

    The mask is True for entries NOT absorbed into the diagonal stream.

    ``min_frac`` rejects thin peels BEFORE the (R, D, 8, 128) planes are
    allocated and scatter-filled: when the selected diagonals would
    absorb less than this fraction of the entries, the peel cannot
    amortize the blocked-y kernel's full x/y scan (see the gate note in
    ``build_general_plan``) — the per-offset counts already answer that,
    so the whole extraction is skipped (ADVICE r3).

    ``signed`` admits super-diagonals (general matrices; the plan then
    targets the one-sided blocked-y kernel). ``mirror`` stores each
    strict-lower diagonal TWICE — offset +d scattered by row and offset
    -d scattered by column (the Lᵀ plane, host-shifted) — so a symmetric
    matrix larger than the whole-y ceiling runs on the blocked-y
    one-sided kernel at 2x value traffic.
    """
    if len(row) == 0:
        return None, np.ones(0, bool)
    off = row - col
    if off.dtype == np.int32 and n > (1 << 30):
        off = off.astype(np.int64)  # off + shift would wrap int32
    # offsets live in [-(n-1), n-1]: one bincount over the shifted key
    # space replaces np.unique's full sort (slow at 200M+ nnz)
    shift = n - 1
    key = off + shift
    cnt_full = np.bincount(key, minlength=2 * n - 1)
    uniq = np.flatnonzero(cnt_full) - shift
    cnt = cnt_full[uniq + shift]
    offsets = select_offsets(
        uniq, cnt, n, fill=fill, min_count=min_count, max_d=max_d,
        mirror=mirror, signed=signed, include_zero=include_zero,
    )
    if offsets is None:
        return None, np.ones(len(row), bool)
    if min_frac > 0.0:
        peeled = int(cnt_full[offsets + shift].sum())
        if peeled < min_frac * len(row):
            info(
                "sdia: peel rejected (%.1f%% of entries < %.0f%% gate)",
                100 * peeled / max(len(row), 1), 100 * min_frac,
            )
            return None, np.ones(len(row), bool)
    ok_full = np.zeros(2 * n - 1, bool)
    ok_full[offsets + shift] = True
    sel = ok_full[key]
    dmap_full = np.full(2 * n - 1, -1, np.int32)
    dmap_full[offsets + shift] = np.arange(len(offsets), dtype=np.int32)

    vals, D, D0, all_offsets = sdia_shell(n, offsets, mirror, dtype)
    g = row[sel]
    j = dmap_full[key[sel]]
    val_c = np.ascontiguousarray(val[sel].astype(dtype))
    from .. import native as _native

    if not _native.assemble_sdia(g, j, 0, D, val_c, vals):
        vals[g // BLOCK_ROWS, j, (g // LANES) % SUBLANES, g % LANES] = (
            val_c
        )
    if mirror:
        # the Lᵀ plane: offset -d holds A[g, g + d] = v_d[g + d], i.e.
        # the same values scattered by COLUMN
        gc = col[sel]
        if not _native.assemble_sdia(gc, j, D0, D, val_c, vals):
            vals[gc // BLOCK_ROWS, D0 + j,
                 (gc // LANES) % SUBLANES, gc % LANES] = val_c
    plan = SDiaPlan(n, all_offsets, vals, int(sel.sum()) * (2 if mirror else 1))
    info(
        "sdia: %d diagonals%s, nnz=%d (%.1f%% of stored), pad=%.2fx",
        D, " (mirrored)" if mirror else "", plan.nnz,
        100 * sel.mean(), plan.padding_ratio,
    )
    return plan, ~sel
