"""SBELL — paired symmetric BELL2: each stored lower-triangle nonzero
feeds both y[r] and y[c].

Host copy of ``cfs_spmv_tpu/formats/sbell.py``, code unchanged (its plans
are held byte-identical to the reference's by
``tests/test_torch_formats.py``). The pairing cost gate's constants were
derived from the reference's TPU kernels; the reference file keeps the
measurements (re-deriving them for the H100 is a ROADMAP item). The
PyTorch port runs every stream of these plans: paired, far and SDIA.

The reference's central idea is symmetric storage: keep the strict lower
triangle + diagonal and fold the transpose contribution in during the
kernel, halving memory traffic (``csr_matrix.tpp:641-1716``). Its cost on
CPUs is write conflicts, solved there by conflict-free coloring. This
layout keeps the storage win and replaces the scatter with static
layout built on *diagonal units*:

- a sublane-row holds one exact diagonal ``(tile, row - col)`` of the
  strict lower triangle. Within a diagonal, row lanes, column lanes and
  gather lanes are all automatically pairwise distinct, so the row-side
  gather (by q = c%128 through the window table) AND the transpose-side
  lane permutation (landing each product on lane c%128) are conflict-free
  with zero search;
- the transpose products of a chunk are accumulated per *window* (each
  window = one 128-column tile = one row tile of y for the transpose),
  giving ≤ n_windows extra (1, 128) stores per chunk;
- both targets must live in one ``tiles_per_block``-tile output block;
  entries crossing a block boundary, or on diagonals too sparse to pay
  for pairing (fill below ``pair_threshold``), go to a one-sided BELL2
  "far" stream holding both mirror images — the analog of the reference's
  HYB bandwidth split (``tpp:313-401``).

Packed int32 bit layout per (subrow i, lane j):
  bits 0-6   q      gather lane, at position j = lane_r of the entry
  bits 7-9   r2     window index, at position j = lane_c (== q);
                    positions with no transpose entry hold the sentinel
                    7 (excluded by every per-window mask)
  bits 10-16 perm   source lane (lane_r), at position j = lane_c
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native as _native
from ..utils import trace
from ..utils.logging import info
from .bell2 import (
    LANES,
    META_W,
    SUBLANES,
    Bell2Plan,
    group_pad,
)
from .coo import COO
from .csr import CSR
from .sdia import (
    SDIA_FILL,
    SDIA_MAX_D,
    SDIA_MIN_COUNT,
    SDiaPlan,
    extract_sdia,
    sdia_shell,
    select_offsets,
)

__all__ = ["SBellPlan", "build_sbell_plan", "PAIR_THRESHOLD"]

#: minimum entries on an exact diagonal for paired storage
PAIR_THRESHOLD = 48

#: minimum fraction of stored entries that must pair for the paired
#: stream to exist at all: a sub-percent paired stream still costs a
#: whole extra kernel launch + its covering chunks while saving almost
#: no traffic
PAIR_MIN_FRACTION = 0.02


@dataclasses.dataclass
class SBellPlan:
    nrows: int
    nnz_full: int
    diag: np.ndarray  # (nrows,)
    vals: np.ndarray  # (C*8, 128) — 2-D like Bell2Plan (native tiles)
    packed: np.ndarray  # (C*8, 128) int32
    meta: np.ndarray  # (C, META_W) int32
    step_block: np.ndarray  # (G,)
    num_row_tiles: int
    x_rows: int
    chunks_per_step: int
    tiles_per_block: int
    nnz_paired: int
    far: Bell2Plan | None
    transpose_windows: int = 2
    dia: SDiaPlan | None = None

    @property
    def num_chunks(self) -> int:
        return int(self.vals.shape[0]) // SUBLANES

    @property
    def padding_ratio(self) -> float:
        # the covering chunks of an EMPTY paired stream are placeholders
        # that never reach the device (sym_to_device skips them)
        slots = (self.vals.size if self.nnz_paired else 0) + (
            0 if self.far is None else self.far.vals.size
        ) + (0 if self.dia is None else self.dia.vals.size)
        stored = (
            self.nnz_paired
            + (0 if self.far is None else self.far.nnz)
            + (0 if self.dia is None else self.dia.nnz)
        )
        return slots / max(stored, 1)

    @property
    def far_fraction(self) -> float:
        f = 0 if self.far is None else self.far.nnz
        return f / max(self.nnz_full, 1)

    def stream_bytes(self) -> int:
        b = (
            self.vals.nbytes + self.packed.nbytes + self.meta.nbytes
            if self.nnz_paired
            else 0
        )
        if self.far is not None:
            b += self.far.stream_bytes()
        if self.dia is not None:
            b += self.dia.stream_bytes()
        return b + self.diag.nbytes


#: per-chunk kernel cost of the paired stream (by transpose-window
#: count TW) and of the one-sided stream, in the reference planner's
#: cost units (derived from its TPU kernels)
_CYC_PAIRED = {2: 16.4, 4: 27.9}
_CYC_ONESIDED = 7.5


def _paired_mode() -> str:
    """CFS_PAIRED: 'auto' (cost-gated, default), 'force' (always pair —
    the pre-round-5 behavior), 'off' (always one-sided)."""
    import os

    m = os.environ.get("CFS_PAIRED", "auto").lower()
    return m if m in ("auto", "force", "off") else "auto"


def _onesided_est_chunks(row, col, T) -> float:
    """Modeled chunk count if the paired entries were mirrored onto the
    one-sided slot-packed stream: max(lane-conflict floor, capacity
    floor) of the mirrored rows, with a 15% pack-overhead margin
    (sweep/first-fit packs land somewhat over their floors)."""
    from .bell2 import _lane_count_table, _lane_floor_chunks, _tile_size_floor

    rows_m = np.concatenate([row, col])
    tbl = _lane_count_table(rows_m, T)
    return 1.15 * max(
        _lane_floor_chunks(tbl), _tile_size_floor(tbl), 1
    )


def _pack_paired(row, col, tile, seg, off, T, transpose_windows):
    """Diagonal-unit pack of the paired stream (shared pack_chunks).

    The window cap trades kernel cost (transpose stores unroll
    statically per window) against packing density: try 2 (enough for
    contiguous bands), widen to 4 when diagonal clusters are scattered
    (stencils). Returns (pack, tw)."""
    from .bell2 import pack_chunks

    off_adj = off - off.min()
    unit_key = tile.astype(np.int64) * (int(off_adj.max()) + 1) + off_adj
    if transpose_windows is not None:
        return pack_chunks(
            unit_key, tile, seg, T, max_windows=transpose_windows
        ), transpose_windows
    pk2 = pack_chunks(unit_key, tile, seg, T, max_windows=2)
    slots2 = len(pk2[3]) * SUBLANES * LANES
    if slots2 > 1.7 * max(len(row), 1):
        pk4 = pack_chunks(unit_key, tile, seg, T, max_windows=4)
        if len(pk4[3]) * 1.33 < len(pk2[3]):
            return pk4, 4
    return pk2, 2


def _stabilize_slots(windows, nwin, tw):
    """Slot-stable window assignment for the lazy paired kernel.

    pack_chunks assigns window slots in first-seen order, so on shifting
    band structure the (slot -> target) map changes at almost every
    chunk even though most targets persist. This pass keeps each target
    in the slot it held in the previous chunk and places new targets in
    freed slots, minimizing per-slot target changes (= transpose-flush
    RMWs in ``_sbell_kernel``). Returns (windows8, nwin, perm): windows8
    is (C0, 8) with -1 marking unused slots (targets may occupy ANY
    subset of slots 0..tw-1 now), perm[ci, old_slot] = new_slot remaps
    the entries' r2 field. O(C0 * tw) host scan."""
    C0 = len(nwin)
    out = np.full((C0, SUBLANES), -1, np.int32)
    perm = np.zeros((C0, SUBLANES), np.int32)
    prev: dict[int, int] = {}
    for ci in range(C0):
        nv = int(nwin[ci])
        real = windows[ci, :nv]
        slots = [-1] * nv
        taken = [False] * tw
        for s0 in range(nv):
            ps = prev.get(int(real[s0]))
            if ps is not None and not taken[ps]:
                slots[s0] = ps
                taken[ps] = True
        free = (w for w in range(tw) if not taken[w])
        cur: dict[int, int] = {}
        for s0 in range(nv):
            if slots[s0] < 0:
                slots[s0] = next(free)
            out[ci, slots[s0]] = real[s0]
            perm[ci, s0] = slots[s0]
            cur[int(real[s0])] = slots[s0]
        prev = cur
    return out, nwin, perm


def build_sbell_plan(
    csr: CSR,
    *,
    dtype=np.float32,
    chunks_per_step: int | None = None,
    tiles_per_block: int | None = None,
    pair_threshold: int = PAIR_THRESHOLD,
    transpose_windows: int | None = None,
    dia: bool = True,
    dia_fill: float = SDIA_FILL,
    dia_min_count: int = SDIA_MIN_COUNT,
    dia_mirror: bool | None = None,
    allow_relax: bool = True,
) -> SBellPlan:
    """Build the paired symmetric plan from lower-triangle CSR storage.

    Dense exact diagonals are first peeled into an index-free SDIA
    stream (``dia=False`` disables, e.g. for sharded sub-plans); the
    residual goes to the paired/far BELL2 streams.
    """
    assert csr.symmetric, "SBELL requires symmetric (lower-triangle) CSR"
    from .bell2 import auto_geometry

    n = csr.nrows
    auto_k, auto_bt = auto_geometry(n, csr.nnz)
    K = chunks_per_step or auto_k
    BT = tiles_per_block or auto_bt
    T = max(1, -(-n // LANES))
    x_rows = T

    with trace.span("cfs.plan.split", log=True, nnz=csr.nnz):
        from .sdia import SDIA_SYM_ROWS_MAX

        # past the reference kernel's whole-y ceiling, mirror the
        # diagonals and run the blocked-y one-sided kernel (at 2x diagonal
        # value traffic)
        mirror = n > SDIA_SYM_ROWS_MAX if dia_mirror is None else dia_mirror
        counts = _native.sym_off_counts(csr.indptr, csr.indices, n)
        if counts is not None:
            # native fast path: TWO CSR passes do the whole diagonal split
            # + dense-diagonal selection + SDIA fill + residual emission
            # (the NumPy formulation below costs ~18 full passes)
            cnt_by_off, ndiag_struct = counts
            data_c = np.ascontiguousarray(np.asarray(csr.data, dtype))
            offsets = None
            if dia and csr.nnz:
                uniq = np.flatnonzero(cnt_by_off)
                offsets = select_offsets(
                    uniq, cnt_by_off[uniq], n, fill=dia_fill,
                    min_count=dia_min_count, max_d=SDIA_MAX_D,
                    mirror=mirror, signed=False,
                )
            dmap = np.full(n, -1, np.int32)
            dia_plan = None
            if offsets is not None:
                vals_sh, D, D0, all_offsets = sdia_shell(
                    n, offsets, mirror, dtype
                )
                dmap[offsets] = np.arange(len(offsets), dtype=np.int32)
                nnz_dia = int(cnt_by_off[offsets].sum())
            else:
                vals_sh = np.zeros(1, dtype)
                D = D0 = nnz_dia = 0
            n_res = csr.nnz - ndiag_struct - nnz_dia
            diag = np.zeros(n, dtype)
            rrow = np.empty(max(n_res, 1), np.int32)
            rcol = np.empty(max(n_res, 1), np.int32)
            rval = np.empty(max(n_res, 1), dtype)
            nres = _native.sym_split_fill(
                csr.indptr, csr.indices, data_c, n, D, D0, dmap,
                mirror and offsets is not None, vals_sh, diag,
                rrow, rcol, rval,
            )
            assert nres == n_res, (nres, n_res)
            row, col, val = rrow[:n_res], rcol[:n_res], rval[:n_res]
            del data_c, dmap
            if offsets is not None:
                dia_plan = SDiaPlan(
                    n, all_offsets, vals_sh, nnz_dia * (2 if mirror else 1)
                )
                info(
                    "sdia: %d diagonals%s, nnz=%d (%.1f%% of stored), "
                    "pad=%.2fx",
                    D, " (mirrored)" if mirror else "", dia_plan.nnz,
                    100 * nnz_dia / max(csr.nnz, 1), dia_plan.padding_ratio,
                )
            nnz_full = 2 * (csr.nnz - ndiag_struct) + int(
                np.count_nonzero(diag)
            )
        else:
            # NumPy fallback (no toolchain, or strict-upper entries found —
            # the latter fails the assert below as before)
            row_all = np.repeat(
                np.arange(n, dtype=np.int32), np.diff(csr.indptr)
            )
            col_all = np.asarray(csr.indices, np.int32)
            data = np.asarray(csr.data)
            on = row_all == col_all
            diag = np.zeros(n, dtype=data.dtype)
            diag[row_all[on]] = data[on]
            if on.any():
                keep = ~on
                row, col, val = row_all[keep], col_all[keep], data[keep]
                del keep
            else:
                row, col, val = row_all, col_all, data.copy()
            del row_all, col_all, on
            assert not np.any(row < col), "SSS storage must be lower-triangle"
            nnz_full = 2 * len(row) + int(np.count_nonzero(diag))

            dia_plan = None
            if dia and len(row):
                dia_plan, resid = extract_sdia(
                    row, col, val, n, dtype=dtype, fill=dia_fill,
                    min_count=dia_min_count, mirror=mirror,
                )
                if dia_plan is not None:
                    row, col, val = row[resid], col[resid], val[resid]

    with trace.span("cfs.plan.pair", log=True) as sp:
        # pairable: same output block AND dense-enough exact diagonal.
        # Per-offset counts bound (and for the post-SDIA residual, equal —
        # SDIA absorbs whole diagonals) the per-(tile, off) counts, so the
        # keyed unique runs only over surviving candidates. The candidate
        # mask itself is one native pass; tile/seg/off materialize only for
        # the (small) surviving streams.
        if counts is not None:
            cnt_off = cnt_by_off  # exact per-offset counts from pass A
        else:
            cnt_off = np.bincount(row - col, minlength=n + 1)
        off_ok = cnt_off >= pair_threshold
        nat = (
            _native.pair_mark(row, col, n, BT * LANES, off_ok, pair_threshold)
            if len(row)
            else None
        )
        if nat is not None:
            pairable, n_pair = nat
        else:
            # NumPy fallback: candidate mask, then per-(tile, off) counts
            # via a keyed unique over the candidates
            pairable = np.zeros(len(row), bool)
            n_pair = 0
            if len(row):
                NB = BT * LANES
                cand = (row // NB == col // NB) & off_ok[
                    (row - col).astype(np.int64)
                ]
                ni = np.flatnonzero(cand)
                if len(ni):
                    rown, coln = row[ni], col[ni]
                    offn = rown - coln
                    dk = (
                        (rown >> 7).astype(np.int64) * (int(offn.max()) + 1)
                        + offn
                    )
                    _, dinv, dcnt = np.unique(
                        dk, return_inverse=True, return_counts=True
                    )
                    pairable[ni] = dcnt[dinv] >= pair_threshold
                    n_pair = int(pairable.sum())
                del cand, ni
        sp.set(paired=n_pair, of=len(row))
        if 0 < n_pair < PAIR_MIN_FRACTION * len(row):
            pairable[:] = False  # not worth a kernel launch
            n_pair = 0

        far_plan = None
        if n_pair:
            fr0, fc0, fv0 = row[~pairable], col[~pairable], val[~pairable]
            # slice the (small) paired stream now so the full-stream copies
            # can be dropped before the far build — peak RSS during that
            # build is the whole plan's memory ceiling
            row, col, val = row[pairable], col[pairable], val[pairable]
        else:
            # scattered fast path: no boolean-gather copies of the full
            # entry stream when everything is far (the audikw shape)
            fr0, fc0, fv0 = row, col, val
            row, col, val = row[:0], col[:0], val[:0]
        tile, seg, off = row >> 7, col >> 7, row - col
        del pairable, cnt_off, off_ok

    # ---- pack the paired stream FIRST, then gate on its real cost ----
    # A paired chunk costs about twice a one-sided one (_CYC_PAIRED vs
    # _CYC_ONESIDED). Pairing halves stored entries but only pays when
    # its pack is dense. CFS_PAIRED=force|auto|off overrides.
    paired_pack = None
    tw = 2
    if len(row):
        paired_pack, tw = _pack_paired(
            row, col, tile, seg, off, T, transpose_windows
        )
        mode = _paired_mode()
        if mode == "off" or (
            mode == "auto"
            and len(paired_pack[3]) * _CYC_PAIRED.get(tw, 28.0)
            > 1.05 * _onesided_est_chunks(row, col, T) * _CYC_ONESIDED
        ):
            info(
                "sbell: paired pack too loose (%d chunks for %d "
                "entries) — routing to the one-sided stream",
                len(paired_pack[3]), len(row),
            )
            fr0 = np.concatenate([fr0, row])
            fc0 = np.concatenate([fc0, col])
            fv0 = np.concatenate([fv0, val])
            row, col, val = row[:0], col[:0], val[:0]
            tile = seg = off = row
            paired_pack = None
    if len(fr0):
        # mirrored triples go straight to the planner (it sorts by
        # (tile, seg, q) itself) — skips a full canonicalize sort + CSR
        # build over 2x the far entries, the largest preprocessing pass
        # on scattered matrices
        from .bell2 import build_bell2_from_arrays

        fr = np.concatenate([fr0, fc0])
        fc = np.concatenate([fc0, fr0])
        fv = np.concatenate([fv0, fv0])
        del fr0, fc0, fv0
        # full K: per-step stream overhead amortizes with K
        far_plan = build_bell2_from_arrays(
            n, n, fr, fc, fv,
            dtype=dtype,
            chunks_per_step=K, tiles_per_block=BT,
            cover_all_tiles=False, allow_relax=allow_relax,
        )
        del fr, fc, fv
        # contig-window far plans enlarge their x gather space to >= 8
        # rows; the shared x operand must cover it (extra rows are zero)
        x_rows = max(x_rows, far_plan.x_rows)

    lane_r = row & 127
    lane_c = col & 127
    nnz_paired = len(row)

    if nnz_paired == 0:
        del paired_pack
        # pure far/SDIA matrix: emit empty covering chunks in the PAIRED
        # layout — int32 packed with the window SENTINEL 7 in the r2
        # field and in-block window sentinels in meta, exactly like real
        # paired padding (the reference's distributed layer stacks these
        # covering chunks, and the one-sided empty plan's int16 packed +
        # zero windows break its paired kernel)
        chunk_tiles = np.arange(T, dtype=np.int64)
        remap, C, blk_full = group_pad(chunk_tiles, K, BT)
        meta = np.zeros((C, META_W), np.int32)
        meta[remap, 0] = (chunk_tiles % BT).astype(np.int32)
        meta[:, 2:] = (blk_full.astype(np.int32) * BT)[:, None]
        return SBellPlan(
            n, nnz_full, diag.astype(dtype),
            np.zeros((C * SUBLANES, LANES), dtype),
            np.full((C * SUBLANES, LANES), 7 << 7, np.int32),
            meta, blk_full[::K].copy(),
            T, x_rows, K, BT, 0, far_plan, 2, dia_plan,
        )

    # diagonal-unit pack computed above (before the routing gate)
    e_chunk, e_sub, e_r2, chunk_tiles, windows, nwin = paired_pack

    # slot stability: re-assign each chunk's windows to the slots their
    # targets held in the PREVIOUS chunk, so the lazy paired kernel's
    # per-slot transpose accumulators flush (one RMW) only when a slot's
    # target actually changes — on shifting-band structure the raw
    # first-seen slot order changes almost every chunk while most
    # TARGETS persist
    windows, nwin, slot_perm = _stabilize_slots(windows, nwin, tw)
    e_r2 = slot_perm[e_chunk, e_r2].astype(np.int64)

    remap, C, blk_full = group_pad(chunk_tiles, K, BT)
    meta = np.zeros((C, META_W), np.int32)
    meta[remap, 0] = (chunk_tiles % BT).astype(np.int32)
    meta[remap, 1] = nwin
    # window sentinel for unused slots must stay inside the chunk's block
    # (the transpose store indexes y by window - block*BT): use the block
    # start tile; padding chunks get their block's sentinel everywhere
    meta[:, 2:] = (blk_full.astype(np.int32) * BT)[:, None]
    sent = (chunk_tiles // BT * BT).astype(np.int32)
    # stabilized windows may occupy any subset of slots 0..tw-1 (-1 =
    # unused); unused slots carry the in-block sentinel
    meta[remap, 2:] = np.where(windows >= 0, windows, sent[:, None])
    # forward-fill K-padding chunks' meta from the last real chunk of the
    # same block (cf. the bell2 lazy-store fill): the lazy paired kernel
    # overwrites row `sub` with a register accumulator that resets on sub
    # change — a padding chunk pointing at sub 0 would wipe that row —
    # and inheriting the windows keeps slot targets unchanged across the
    # padding (zero contributions, no flushes)
    written = np.zeros(C, bool)
    written[remap] = True
    if C and not written.all():
        src = np.maximum.accumulate(np.where(written, np.arange(C), -1))
        fillp = ~written & (src >= 0) & (blk_full == blk_full[src])
        meta[fillp] = meta[src[fillp]]
    step_block = blk_full[::K].copy()

    vals_arr = np.zeros((C, SUBLANES, LANES), dtype)
    ec = remap[e_chunk]
    vals_arr[ec, e_sub, lane_r] = np.asarray(val, dtype)
    q_field = np.zeros((C, SUBLANES, LANES), np.int32)
    q_field[ec, e_sub, lane_r] = lane_c
    # positions with no transpose entry carry the window SENTINEL 7
    # (>= any real transpose window, so the per-window masks exclude
    # them) — replaces a separate validity bit and its kernel ops
    t_field = np.full((C, SUBLANES, LANES), 7 << 7, np.int32)
    t_field[ec, e_sub, lane_c] = (e_r2 << 7) | (lane_r << 10)
    pk = q_field | t_field

    plan = SBellPlan(
        n, nnz_full, diag.astype(dtype),
        vals_arr.reshape(C * SUBLANES, LANES),
        pk.reshape(C * SUBLANES, LANES),
        meta, step_block,
        T, x_rows, K, BT, nnz_paired, far_plan, tw, dia_plan,
    )
    info(
        "sbell: n=%d nnz_full=%d dia=%d paired=%d far=%d chunks=%d "
        "pad=%.2fx",
        n, nnz_full, 0 if dia_plan is None else dia_plan.nnz, nnz_paired,
        0 if far_plan is None else far_plan.nnz, C, plan.padding_ratio,
    )
    return plan
