"""BELL2 — segmented banded-ELL, the tuned sparse layout.

Host copy of ``cfs_spmv_tpu/formats/bell2.py``, code unchanged (its plans
are held byte-identical to the reference's by
``tests/test_torch_formats.py``). The planner's cost constants were
derived from measurements of the reference's TPU kernels; the comments
here say what each constant decides, and the reference file keeps the
measurements. They are not the port's.

Core ideas (replacing the reference's tuned-CSR + conflict-free coloring
machinery, ``csr_matrix.tpp:230-310, 1204-1639``):

- Rows are grouped into 128-row tiles; a chunk is an (8, 128) slot grid
  whose lane j always holds entries of row ``tile*128 + j``, so row sums
  are pure sublane reductions — scatter (and therefore coloring) does not
  exist.
- Each chunk carries up to eight 128-aligned, 128-wide x *windows*
  (``meta[c, 1 + w]`` = row of the (x_rows, 128) x operand). x values are
  fetched with a two-step hardware gather: a sublane gather through the
  per-(subrow, gather-lane) window table ``r2`` followed by a lane gather
  by ``q = c % 128``.
- Sublane-rows are built from two kinds of *units*:

  * **diagonal units** ``(tile, row - col)``: all entries on one exact
    diagonal offset. Within such a unit lane_r, lane_c and q are
    automatically pairwise distinct and at most two windows are touched —
    dense bands and stencils pack at full fill. (This is the layout's
    analog of the reference's bandwidth-structure exploitation.)
  * **row-segment units** ``(tile, col//128, occurrence)``: the fallback
    for scattered structure; an entry can always be placed, so the plan
    is total — no spill stream exists.

- Chunks pack consecutive subrow units of a tile while the union of
  their windows fits the 8 window slots.

Per-chunk metadata is a (C, 10) table streamed with the chunks, so chunk
count — and matrix size — is not limited by a scalar-memory capacity.

Packed int32 bit layout per (subrow i, lane j):
  bits 0-6   q       gather lane of the entry AT slot (i, j)  [j = lane_r]
  bits 7-9   r2      window index serving gather-lane j of subrow i
(the two fields live at different logical positions of the same array and
are OR-combined; a position may carry both roles simultaneously).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native as _native
from ..utils import trace
from ..utils.logging import info
from .csr import CSR

__all__ = [
    "Bell2Plan",
    "build_bell2_plan",
    "build_bell2_from_arrays",
    "build_general_plan",
    "auto_geometry",
    "LANES",
    "SUBLANES",
    "META_W",
    "DIAG_THRESHOLD",
]

LANES = 128
SUBLANES = 8
META_W = 2 + SUBLANES  # [sub_in_block, n_windows, win0..win7]

#: minimum entries on an exact diagonal for it to become a diagonal unit
DIAG_THRESHOLD = 48


@dataclasses.dataclass
class Bell2Plan:
    """Device layout for one BELL2 stream (C chunks, G = C/K grid steps)."""

    nrows: int
    ncols: int
    nnz: int
    #: (C*8, 128) — chunk c is rows [8c, 8c+8). Stored 2-D so 16-bit
    #: streams (int16 packed, bfloat16 values) tile natively as
    #: (16, 128) on the TPU without half-empty (8, 128) tiles
    vals: np.ndarray  # (C*8, 128) dtype
    packed: np.ndarray  # (C*8, 128) int16 (q | r2<<7)
    meta: np.ndarray  # (C, META_W) int32
    step_block: np.ndarray  # (G,) int32
    num_row_tiles: int
    x_rows: int  # rows of the (x_rows, 128) x operand
    chunks_per_step: int
    tiles_per_block: int
    #: chunks per same-tile run: the kernel accumulates a run in
    #: register and does one sum + read-modify-write per run (every
    #: tile's chunk count is padded to a run multiple)
    run_len: int = 1
    #: static per-chunk window capacity: the kernel stacks only this
    #: many window rows (slot-packed plans rarely need more than 4)
    max_windows: int = SUBLANES
    #: contiguous-range windows: chunk c's windows are exactly rows
    #: [meta[c,2], meta[c,2]+8) of the x operand, so the kernel loads the
    #: whole stack as ONE dynamic (8,128) slab (~2 cycles/chunk cheaper
    #: than 8 row loads). The windows table is still materialized, so
    #: such plans also run correctly under the non-contig kernels.
    windows_contig: bool = False
    #: relaxed packing (scattered structure): ``window_depth`` > 8 widens
    #: the contig window range to 16/32 segments (r2 grows to 5 bits,
    #: packed bits 7-11; the kernel stacks depth/8 slabs and selects) —
    #: trades per-chunk compute for fewer chunks, chosen by the
    #: packing-floor model in ``_choose_slot_packing``.
    window_depth: int = 8
    #: always 1: lane rotation (an entry occupying any lane of its
    #: coset) was pruned from the reference planner — its per-chunk
    #: cost outweighed an at-best-2x chunk saving. The field (and packed
    #: bits 12-13) stays reserved for plan-format stability.
    lane_rot: int = 1
    #: sparse accumulating stream (built with cover_all_tiles=False):
    #: blocks without chunks are never visited, so the kernel must run
    #: in accumulate mode against an initialized y (far residuals and
    #: post-peel residuals use this — covering chunks for empty tiles
    #: would otherwise cost as much traffic as the data itself)
    sparse_stream: bool = False
    #: degree-grouped row tiling (scattered structure with high
    #: row-degree variance): rows are re-grouped into 128-row tiles by
    #: descending stream degree, so each tile's 128 lanes carry
    #: near-equal multiplicity and the lane-conflict floor collapses to
    #: the capacity floor — at ZERO kernel cost (the kernel is
    #: permutation-blind; only the plan's tile/lane assignment changes).
    #: ``row_perm[r]`` is the packed slot of original row r, or the
    #: sentinel ``num_row_tiles*128`` for rows with no entries in this
    #: stream; apply unpermutes y with one O(n) XLA gather against a
    #: zero-extended flat output. Grouped plans are always dense over
    #: their compact tile range (never ``sparse_stream``) because the
    #: zero-degree rows sort to the end. Replaces the reference's
    #: conflict balancing (``csr_matrix.tpp:2009-2363``) for the
    #: dense-row/variance case the lane-pinned layout cannot absorb.
    row_perm: np.ndarray | None = None  # (nrows,) int32
    #: unpermute plan for grouped streams (``_build_unperm`` /
    #: ``ops/bell2_kernel.unperm_gather_tiles``): per-1024-row out-block
    #: slab lists + per-row packed gather words.
    unperm_pk: np.ndarray | None = None  # (nb*8, 128) int32
    unperm_slabs: np.ndarray | None = None  # (nb, W<=16) int32
    #: optional signed-offset dense-diagonal stream peeled off a general
    #: square matrix (SDiaPlan; ops/sdia_kernel.sdia_gen_tiles) — the
    #: general-matrix analog of the symmetric SDIA peel
    dia: object | None = None
    #: optional second value plane in the SAME slot layout (the fp32 lo
    #: halves of double-float fp64 storage; ``ops/bell2_df``)
    vals2: np.ndarray | None = None  # (C*8, 128) float32

    @property
    def num_chunks(self) -> int:
        return int(self.vals.shape[0]) // SUBLANES

    @property
    def padding_ratio(self) -> float:
        slots = self.vals.size + (
            0 if self.dia is None else self.dia.vals.size
        )
        stored = self.nnz + (0 if self.dia is None else self.dia.nnz)
        return slots / max(stored, 1)

    @property
    def nnz_total(self) -> int:
        """Stored entries including the peeled diagonal stream."""
        return self.nnz + (0 if self.dia is None else self.dia.nnz)

    @property
    def spill_fraction(self) -> float:
        return 0.0  # the layout is total

    def stream_bytes(self) -> int:
        b = self.vals.nbytes + self.packed.nbytes + self.meta.nbytes
        if self.dia is not None:
            b += self.dia.stream_bytes()
        return b


def auto_geometry(nrows: int, nnz: int) -> tuple[int, int]:
    """(chunks_per_step, tiles_per_block) adapted to problem size.

    Large K amortizes per-step kernel overhead but costs K-chunk
    padding, so small matrices use smaller steps. (Tuned on the TPU
    reference; ROADMAP lists re-deriving K/BT for the H100.)
    """
    T = max(1, -(-nrows // LANES))
    approx_chunks = max(T, nnz // (SUBLANES * LANES))
    if approx_chunks >= 512:
        # big steps amortize per-step overhead; K-padding costs at most
        # (K-1)/C chunks, negligible from C >= 512
        K = 128
    elif approx_chunks >= 64:
        K = 32
    else:
        K = 8
    # output block: the whole y up to 512 tiles (65,536 rows) per
    # block. A single block removes block-boundary far entries for the
    # symmetric paired stream; the 512 cap comes from the reference's
    # TPU SpMM kernels (see the reference file).
    BT = min(-(-T // 8) * 8, 512)
    return K, BT


def _occurrence(keys: np.ndarray) -> np.ndarray:
    """Rank of each element within its (sorted-stable) key group."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    starts = np.flatnonzero(first)
    ranks = np.arange(len(ks)) - starts[np.cumsum(first) - 1]
    out = np.empty(len(ks), np.int64)
    out[order] = ranks
    return out


def plan_units(row, col, nnz, diag_threshold=DIAG_THRESHOLD):
    """Split entries into diagonal / row-segment subrow units.

    Returns per-entry ``unit_key`` — a lexicographic (tile, kind, a, b)
    tuple encoded as int64, where diagonal units sort before row-segment
    units within a tile — plus each entry's (lane, q, seg).
    """
    # the unit keys multiply tile by per-tile ranges: int64 throughout
    # (this path only sees small residual/paired streams)
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    tile = row >> 7
    lane = row & 127
    seg = col >> 7
    q = col & 127

    off = row - col  # diagonal offset (any sign for general matrices)
    off_adj = off - off.min() if nnz else off
    dkey = tile * (off_adj.max() + 1 if nnz else 1) + off_adj
    # count per exact diagonal within tile
    uniq_d, dinv, dcnt = np.unique(dkey, return_inverse=True,
                                   return_counts=True)
    is_diag = dcnt[dinv] >= diag_threshold

    # diagonal units: (tile, 0, off_adj, 0)
    # rowseg units: (tile, 1, seg, occurrence within (row, seg))
    rs_occ = _occurrence(row * (seg.max() + 1 if nnz else 1) + seg)

    A = (off_adj.max() + 1 if nnz else 1)
    B = (seg.max() + 1 if nnz else 1)
    O = (rs_occ.max() + 1 if nnz else 1)
    M = max(A, B * O)
    unit_key = tile * 2 * M + np.where(
        is_diag, off_adj, M + seg * O + rs_occ
    )
    return unit_key, tile, lane, q, seg


def pack_chunks(unit_key, tile, seg, T, max_windows=SUBLANES,
                ensure_tiles=True):
    """Assign (chunk, subrow) to each unit and windows to each chunk.

    Greedy scan of a tile's units in key order: a unit joins the current
    chunk while subrows < 8 and the union of needed windows fits
    ``max_windows`` slots (≤ 8; the paired symmetric kernel uses 4 so its
    per-window transpose stores can be statically unrolled).
    Returns per-entry (chunk, subrow, window-index), per-chunk
    (tile, windows[8]) and the chunk count.
    """
    # order entries by (unit, seg) so each unit's windows are contiguous
    order = np.lexsort((seg, unit_key))
    u = unit_key[order]
    s = seg[order]
    t = tile[order]

    # boundaries
    new_unit = np.ones(len(u), bool)
    new_unit[1:] = u[1:] != u[:-1]
    new_win = new_unit.copy()
    new_win[1:] |= s[1:] != s[:-1]  # new (unit, seg) pair
    new_tile = new_unit.copy()
    new_tile[1:] &= t[1:] != t[:-1]

    # per-(unit,seg) and per-unit ids in sorted order
    uw_id = np.cumsum(new_win) - 1  # distinct (unit, window-need) pairs
    unit_id = np.cumsum(new_unit) - 1

    n_units = int(unit_id[-1]) + 1 if len(u) else 0
    first_of_unit = np.flatnonzero(new_unit)
    unit_tile = t[first_of_unit]

    # distinct (unit, seg) needs, flattened in order
    uw_pos = np.flatnonzero(new_win)
    uw_unit = unit_id[uw_pos]
    uw_seg = s[uw_pos]
    uw_start = np.searchsorted(uw_unit, np.arange(n_units))
    uw_end = np.searchsorted(uw_unit, np.arange(n_units) + 1)

    # greedy chunk packing per tile with window dedup — native C++ scan
    # (csrc/cfs_native.cpp:cfs_pack_units) with an identical Python
    # fallback; the scan is the one inherently sequential planner step
    packed_native = _native.pack_units(
        uw_start, uw_end, uw_seg, unit_tile, SUBLANES, max_windows
    )
    if packed_native is not None:
        (chunk_of_unit, subrow_of_unit, uw_slot,
         chunk_tiles, windows, nwin) = packed_native
        C0 = len(chunk_tiles)
    else:
        chunk_of_unit = np.zeros(n_units, np.int64)
        subrow_of_unit = np.zeros(n_units, np.int64)
        uw_slot = np.zeros(len(uw_pos), np.int64)
        chunk_tiles = []
        chunk_windows = []  # list of per-chunk window lists
        cur_tile = -1
        cur_sub = SUBLANES
        winmap: dict = {}
        for k in range(n_units):
            segs = uw_seg[uw_start[k] : uw_end[k]]
            fresh = [sg for sg in segs if sg not in winmap]
            if (
                unit_tile[k] != cur_tile
                or cur_sub >= SUBLANES
                or len(winmap) + len(fresh) > max_windows
            ):
                cur_tile = unit_tile[k]
                cur_sub = 0
                winmap = {}
                fresh = list(dict.fromkeys(segs))
                chunk_tiles.append(cur_tile)
                chunk_windows.append([])
            for sg in fresh:
                winmap[sg] = len(winmap)
                chunk_windows[-1].append(sg)
            for idx in range(uw_start[k], uw_end[k]):
                uw_slot[idx] = winmap[uw_seg[idx]]
            chunk_of_unit[k] = len(chunk_tiles) - 1
            subrow_of_unit[k] = cur_sub
            cur_sub += 1

        C0 = len(chunk_tiles)
        chunk_tiles = (
            np.asarray(chunk_tiles, np.int64) if C0 else np.zeros(0, np.int64)
        )
        windows = np.zeros((C0, SUBLANES), np.int32)
        nwin = np.zeros(C0, np.int32)
        for ci, wl in enumerate(chunk_windows):
            windows[ci, : len(wl)] = wl
            nwin[ci] = len(wl)

    # window slot per entry via its (unit, seg) pair
    r2_sorted = uw_slot[uw_id]

    # scatter back to original entry order
    e_chunk = np.empty(len(u), np.int64)
    e_sub = np.empty(len(u), np.int64)
    e_r2 = np.empty(len(u), np.int64)
    e_chunk[order] = chunk_of_unit[unit_id]
    e_sub[order] = subrow_of_unit[unit_id]
    e_r2[order] = r2_sorted

    # ensure every tile has at least one chunk (empty tiles)
    present = np.zeros(T, bool)
    if C0:
        present[chunk_tiles] = True
    missing = np.flatnonzero(~present) if ensure_tiles else np.zeros(0, np.int64)
    if len(missing):
        chunk_tiles = np.concatenate([chunk_tiles, missing])
        windows = np.concatenate(
            [windows, np.zeros((len(missing), SUBLANES), np.int32)]
        )
        nwin = np.concatenate([nwin, np.zeros(len(missing), np.int32)])
    # sort chunks by tile (stable keeps intra-tile order)
    corder = np.argsort(chunk_tiles, kind="stable")
    cremap = np.empty(len(chunk_tiles), np.int64)
    cremap[corder] = np.arange(len(chunk_tiles))
    e_chunk = cremap[e_chunk]
    chunk_tiles = chunk_tiles[corder]
    windows = windows[corder]
    nwin = nwin[corder]
    return e_chunk, e_sub, e_r2, chunk_tiles, windows, nwin


def _sort_entries(row, col):
    """Combined-key stable sort of the entry stream into the packer's
    required (tile, seg, q) order. One radix argsort (faster than the
    3-pass lexsort; keys fit int64 for any n*m/128 < 2^63 matrix); the
    sorted copies are shared by every packing
    candidate so each candidate pays only the native pack itself.
    Gathers the two int32 raw streams and derives (tile, lane, seg, q)
    sequentially — half the random-access bytes of gathering four
    int64 component arrays. Coordinates must fit int32 (< 2^31 rows
    and cols — guarded by build_bell2_from_arrays)."""
    if not len(row):
        z = np.zeros(0, np.int32)
        return np.zeros(0, np.int64), z, z, z, z
    # (tile*S + seg)*128 + q == tile*(S*128) + col; build the key with
    # in-place ops — two fewer 8B/entry temporaries (page faults of
    # fresh allocations dominate)
    with trace.span("cfs.plan.sort", log=True, n=len(row)):
        S128 = ((int(col.max()) >> 7) + 1) * 128
        key = row.astype(np.int64, copy=True)
        key >>= 7
        key *= S128
        key += col
        order = np.argsort(key, kind="stable")
        del key  # 8B/entry, dead — keep peak RSS under the host's cliff
        rs = np.asarray(row, np.int32)[order]
        cs = np.asarray(col, np.int32)[order]
    return order, rs >> 7, rs & 127, cs >> 7, cs & 127


#: stream size up to which BOTH contig packers run and the smaller plan
#: wins; above it the span predictor picks one so full-scale
#: preprocessing stays single-pass
_SWEEP_DUAL_MAX = 20_000_000


def _entry_weighted_span_frac(ts, sgs, T, depth):
    """Fraction of entries living in tiles whose segment span exceeds
    ``depth`` (sgs ascend within each tile, so the span reads off the
    tile's boundary entries)."""
    bounds = np.searchsorted(ts, np.arange(T + 1))
    s, e = bounds[:-1], bounds[1:]
    nz = e > s
    if not nz.any():
        return 0.0
    last = np.minimum(np.maximum(e - 1, s), len(sgs) - 1)
    first = np.minimum(s, len(sgs) - 1)
    span = sgs[last] - sgs[first] + 1  # garbage on empty tiles (masked)
    wide = nz & (span > depth)
    return float((e - s)[wide].sum() / max((e - s)[nz].sum(), 1))


def _pack_slots_entries(ts, lrs, sgs, qs, T, *, ensure_tiles=True,
                        max_windows=SUBLANES, contig=False, rot=1):
    """Entry-level conflict-aware packing (native cfs_pack_slots with a
    Python mirror): subrows mix segments as long as row lanes and gather
    lanes stay conflict-free. Inputs MUST already be in ``_sort_entries``
    order; outputs are pack_chunks-shaped in that same SORTED order (the
    plan assembly scatters values/indices straight from the sorted
    domain — the former scatter-back to entry order was 4 random passes
    over the whole entry set per candidate). Superchunk packing
    (``group > 1``) was pruned from the reference: window sharing never
    reduced chunks, so no plan could reach it (the
    native ``pack_slots`` keeps its ``group`` ABI parameter frozen
    at 1)."""
    with trace.span("cfs.plan.pack", log=True, n=len(ts), mw=max_windows,
                    rot=rot) as sp:
        packed = None
        if contig and rot == 1:
            # anchor-sweep packing: per-tile minimum-unassigned-seg
            # anchors + maximal per-lane prefixes — optimal for the
            # per-lane capacity relaxation. Wins when the window range
            # binds (tile seg span > depth: the first-fit ring's staggered
            # anchors strand capacity); loses a little when windows are
            # slack (its denser chunks take more gather-lane conflicts).
            # Small streams pack BOTH and keep the smaller plan; big
            # streams pick by the entry-weighted span predictor to keep
            # full-scale preproc single-pass.
            want_sweep = want_ff = True
            if len(ts) > _SWEEP_DUAL_MAX:
                spans = _entry_weighted_span_frac(ts, sgs, T, max_windows)
                want_sweep = spans > 0.3
                want_ff = not want_sweep
            pk_sw = None
            if want_sweep:
                pk_sw = _native.pack_slots_sweep(ts, lrs, sgs, qs, max_windows)
                if pk_sw is None:
                    pk_sw = _native.pack_slots_sweep_py(
                        ts, lrs, sgs, qs, max_windows
                    )
            if want_ff:
                packed = _native.pack_slots(
                    ts, lrs, sgs, qs, max_windows, contig=contig, rot=rot
                )
                if packed is None:
                    packed = _native.pack_slots_py(
                        ts, lrs, sgs, qs, max_windows, contig=contig, rot=rot,
                    )
            if pk_sw is not None and (
                packed is None or len(pk_sw[4]) < len(packed[4])
            ):
                packed = pk_sw
        else:
            packed = _native.pack_slots(
                ts, lrs, sgs, qs, max_windows, contig=contig, rot=rot
            )
            if packed is None:
                packed = _native.pack_slots_py(
                    ts, lrs, sgs, qs, max_windows, contig=contig, rot=rot,
                )
        e_chunk, e_sub, e_r2, e_rc, chunk_tiles, windows, nwin = packed
        sp.set(chunks=len(chunk_tiles))
    # cover empty tiles (same contract as pack_chunks)
    present = np.zeros(T, bool)
    if len(chunk_tiles):
        present[chunk_tiles] = True
    missing = (
        np.flatnonzero(~present) if ensure_tiles else np.zeros(0, np.int64)
    )
    if len(missing):
        chunk_tiles = np.concatenate([chunk_tiles, missing])
        windows = np.concatenate(
            [windows, np.zeros((len(missing), SUBLANES), np.int32)]
        )
        nwin = np.concatenate([nwin, np.zeros(len(missing), np.int32)])
        corder = np.argsort(chunk_tiles, kind="stable")
        cremap = np.empty(len(chunk_tiles), e_chunk.dtype)
        cremap[corder] = np.arange(len(chunk_tiles))
        e_chunk = cremap[e_chunk]
        chunk_tiles = chunk_tiles[corder]
        windows = windows[corder]
        nwin = nwin[corder]
    return e_chunk, e_sub, e_r2, e_rc, chunk_tiles, windows, nwin


#: one-sided kernel cost model, in the reference planner's cost units
#: per chunk (derived from its TPU kernels; the reference file keeps the
#: measurements). Used only to RANK packing candidates — identical
#: across native/Python packers so plans stay reproducible.
_CYC_CONTIG = 7.3
_CYC_DISTINCT = 11.4
#: per-extra-slab cost of deep windows (gather + select per extra
#: (8, 128) slab)
_CYC_SLAB = 0.5
#: lane rotation (rot 2/4) was pruned from the reference planner: its
#: per-chunk cost always outweighed the at-best-halved chunk count. The
#: packed bits 12-13 (rc) and the native packer's rot ABI remain
#: reserved.
#: unpermute cost of degree-grouped plans, per 1024-row out-block of the
#: window-row kernel (ops/bell2_kernel.unperm_gather_tiles): base +
#: per-window-row cost per block.
_CYC_UNPERM_BASE = 4.0
_CYC_UNPERM_SLAB = 4.0
#: minimum fraction of a general matrix's nnz an SDIA peel must absorb
#: to be kept (see the gate in ``build_general_plan``): the blocked-y
#: kernel's full x/y scan only pays off when the peel is substantial.
SDIA_PEEL_MIN_FRAC = 0.25


def _cyc_per_chunk(depth, rot=1):
    assert rot == 1  # lane rotation pruned (see note above)
    return _CYC_CONTIG + _CYC_SLAB * (depth // SUBLANES - 1)


def _lane_count_table(row, T):
    """Per-(tile, lane) entry counts as a (T, 128) table — one O(nnz)
    bincount over the row stream (tile*128 + lane IS the row index).
    Every packing floor derives from this table, so the planner pays
    the pass once per layout instead of one keyed np.unique per floor
    query."""
    return np.bincount(row, minlength=T * LANES)[: T * LANES].reshape(
        T, LANES
    )


def _lane_floor_chunks(tbl, rot=1):
    """The packing lower bound: sum over tiles of ceil(max per-lane-coset
    row multiplicity / (8*rot)) — with ``rot`` rotation groups an entry
    of row lane l may occupy any of the rot lanes {l, l+128/rot, ...},
    so the binding multiplicity is per coset and each chunk offers
    8*rot slots to it."""
    T = len(tbl)
    stride = LANES // rot
    coset = tbl.reshape(T, rot, stride).sum(axis=1) if rot > 1 else tbl
    per_tile_max = coset.max(axis=1)
    return int(np.ceil(per_tile_max / (SUBLANES * rot)).sum())


def _tile_size_floor(tbl):
    """Chunk count lower bound from capacity alone: ceil(per-tile
    entries / 1024) summed (a chunk holds 8x128 slots)."""
    return int(np.ceil(tbl.sum(axis=1) / (SUBLANES * LANES)).sum())


def _degree_class(counts):
    """Monotone degree-class key for grouped row ordering.

    Exact ceil(count/8) up to class 8 — every count in one class shares
    ceil(max/8), so class-bucketed ordering is FLOOR-EXACT there — and
    geometric (x1.25) above, which bounds the number of distinct classes
    (and therefore each out-block's unpermute slab count) at a few
    percent floor cost on heavy tails. Within a class rows keep their
    original order, so each out-block's slots form one contiguous run
    per class — the structural guarantee behind the O(1)-slab unpermute
    kernel (``_build_unperm``)."""
    c = -(-counts // SUBLANES).astype(np.int64)
    exact = 32  # classes 1..32 exact (degrees <= 256)
    big = c > exact
    if np.any(big):
        c = c.copy()
        c[big] = exact + np.ceil(
            np.log(c[big] / exact) / np.log(1.25)
        ).astype(np.int64)
    return c


def _perm_floor_chunks(counts):
    """Lane floor achievable by degree-grouped row tiling (rows ordered
    by descending degree CLASS, original order within a class — the
    layout ``_try_degree_grouping`` actually builds). Returns (floor,
    compact tile count)."""
    nz = counts[counts > 0]
    if len(nz) == 0:
        return 1, 1
    srt = nz[np.argsort(-_degree_class(nz), kind="stable")]
    Tc = -(-len(srt) // LANES)
    heads = np.maximum.reduceat(srt, np.arange(0, len(srt), LANES))
    return int(np.ceil(heads / SUBLANES).sum()), Tc


def _radius_floor(counts, radius):
    """Lane floor when rows are class-sorted only WITHIN each
    ``radius``-row neighborhood (locality-preserving grouping)."""
    n = len(counts)
    nb = -(-n // radius)
    cpad = np.concatenate(
        [counts, np.zeros(nb * radius - n, counts.dtype)]
    ).reshape(nb, radius)
    order = np.argsort(-_degree_class(cpad.ravel()).reshape(nb, radius),
                       axis=1, kind="stable")
    srt = np.take_along_axis(cpad, order, axis=1)
    heads = srt.reshape(nb, radius // LANES, LANES).max(axis=2)
    return int(np.ceil(heads / SUBLANES).sum())


#: unpermute kernel slab capacity: one 1024-row out-block may source its
#: slots from at most this many (8, 128) slabs of the grouped output
#: (r2 = w*8 + sub needs w < 16 to fit bits 7-13 of the int32 word)
_UNPERM_WMAX = 16


def _build_unperm(perm, sentinel):
    """Window-row unpermute plan for ``unperm_gather_tiles``.

    Per 1024-row out-block: the (1, 128) tile rows of the grouped output
    its live slots touch (class-bucketed grouping keeps each block's
    slots in one contiguous run per degree class, so this list stays
    short), plus a per-row packed word q | w<<7 (w = index into the
    block's window-row list, q = slot lane) or -1 for rows that must
    read exact 0. Returns (pk2d (nb*8, 128) int32, rows (nb, W) int32,
    W), or None when some block needs more than ``_UNPERM_WMAX`` window
    rows (the caller then rejects grouping entirely)."""
    n = len(perm)
    nb = -(-n // (SUBLANES * LANES))
    live = perm < sentinel
    p64 = perm.astype(np.int64)
    blk = np.arange(n, dtype=np.int64) >> 10
    key = (blk << 32) | (p64 >> 7)
    uniq = np.unique(key[live])
    if len(uniq) == 0:
        return None
    ub = uniq >> 32
    cnt = np.bincount(ub, minlength=nb)
    W = int(cnt.max())
    if W > _UNPERM_WMAX:
        return None
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    rows = np.zeros((nb, W), np.int32)
    rows[ub, np.arange(len(uniq)) - starts[ub]] = (
        uniq & 0xFFFFFFFF
    ).astype(np.int32)
    pk = np.full(nb * SUBLANES * LANES, -1, np.int32)
    li = np.flatnonzero(live)
    w_of = (
        np.searchsorted(uniq, key[li]) - starts[blk[li]]
    ).astype(np.int64)
    pl64 = p64[li]
    pk[li] = ((pl64 & 127) | (w_of << 7)).astype(np.int32)
    return pk.reshape(nb * SUBLANES, LANES), rows, W


def _unperm_cost_cyc(unp, n):
    """Modeled unpermute kernel cycles (see _CYC_UNPERM_*)."""
    if unp is None:
        return float("inf")
    nb = unp[1].shape[0]
    return nb * (_CYC_UNPERM_BASE + _CYC_UNPERM_SLAB * unp[2])


#: locality-preserving grouping radii tried besides global compaction:
#: rows are re-sorted by degree only within an R-row neighborhood, so a
#: chunk mixes rows whose columns still sit near each other (banded /
#: block structure keeps its window locality)
_GROUP_RADII = (512, 1024, 8192)
#: up to this many entries every radius candidate is PACKED and ranked
#: by modeled cost (chunks x cycles + unpermute): the floor is a bad
#: proxy once window binding enters — on the near_band_paired far
#: stream the radius with the BEST floor (8192: 1702) packs 2111
#: chunks while radius 512 (floor 1861) packs 1989. Bigger streams
#: keep the one-pack floor heuristic (each candidate pack costs real
#: host time at scale).
_GROUP_PACK_EVAL_MAX = 4_000_000


def _pack_grouped(radius, counts, cls, row, col, n, K, BT, *,
                  allow_runs, max_windows):
    """Pack one grouped-layout candidate (global compaction when
    ``radius`` is None) and price it: chunks x cycles/chunk + the
    unpermute kernel cost. Returns the adoption dict or None (unpermute
    slab capacity exceeded)."""
    if radius is None:
        order = np.argsort(-cls, kind="stable")
        T_out = _perm_floor_chunks(counts)[1]
    else:
        # block-local class sort: (block asc, class desc, row asc)
        blocks = np.arange(n, dtype=np.int64) // radius
        order = np.lexsort((np.arange(n), -cls, blocks))
        T_out = -(-n // LANES)
    slot_of_row = np.empty(n, np.int32)
    slot_of_row[order] = np.arange(n, dtype=np.int32)
    new_row = slot_of_row[row]
    # the grouped layout's lane-count table is just the per-row counts
    # gathered into slot order (slots past T_out*128 are all zero-count
    # rows under global compaction)
    tbl_g = np.zeros(T_out * LANES, counts.dtype)
    m_slots = min(n, T_out * LANES)
    tbl_g[:m_slots] = counts[order][:m_slots]
    pk, contig, run_pick, depth, rot, ctx = _choose_slot_packing(
        new_row, col, T_out, K,
        ensure_tiles=(radius is None),
        allow_runs=allow_runs, max_windows=max_windows, allow_relax=True,
        tbl=tbl_g.reshape(T_out, LANES),
    )
    # rows whose output block is never visited by the sparse grid (and
    # zero-degree rows under global compaction) read an exact 0 through
    # the sentinel one past the flat output
    sentinel = np.int64(T_out * LANES)
    if radius is None:
        perm = np.where(counts > 0, slot_of_row, sentinel)
    else:
        nb_out = -(-T_out // BT)
        visited = np.zeros(nb_out, bool)
        visited[np.asarray(pk[4]) // BT] = True
        perm = np.where(
            visited[(slot_of_row >> 7) // BT], slot_of_row, sentinel
        )
    perm = perm.astype(np.int32)
    unp = _build_unperm(perm, sentinel)
    if unp is None:
        # some out-block would exceed the unpermute kernel's slab
        # capacity — this grouping is not available
        return None
    cost = len(pk[4]) * _cyc_per_chunk(depth, rot) + _unperm_cost_cyc(
        unp, n
    )
    return dict(
        pk=pk, contig=contig, run_pick=run_pick, depth=depth, rot=rot,
        T=T_out, ctx=ctx, perm=perm,
        cost=cost, radius=radius, unperm=unp,
    )


def _try_degree_grouping(row, col, n, K, BT, *, allow_runs,
                         max_windows=SUBLANES, strict_floor=None):
    """Evaluate degree-grouped row tiling against the in-order layout.

    Returns ``None`` when no grouped floor (plus the apply-time
    unpermute margin) can beat the in-order lane floor. Small streams pack
    EVERY radius candidate and keep the cheapest by modeled cost
    (see ``_GROUP_PACK_EVAL_MAX``); big streams pick the smallest
    radius whose floor is within 5% of the best and pack once. The
    grouped grid is sparse (blocks without chunks are skipped); rows
    living in skipped blocks are routed to the zero sentinel at apply
    time."""
    counts = np.bincount(row, minlength=n)
    # optimistic unpermute charge for the early gate (W >= 2 slabs)
    margin = int(
        (-(-n // 1024)) * (_CYC_UNPERM_BASE + 2 * _CYC_UNPERM_SLAB)
        / _CYC_CONTIG
    ) + 1
    floor_g, Tc = _perm_floor_chunks(counts)
    cands = [(None, floor_g)]
    for R in _GROUP_RADII:
        if R < n:
            cands.append((R, _radius_floor(counts, R)))
    best_floor = min(f for _, f in cands)
    if strict_floor is not None and (
        best_floor + margin >= 0.9 * strict_floor
    ):
        return None
    cls = _degree_class(counts)
    if len(row) <= _GROUP_PACK_EVAL_MAX:
        best = None
        for radius, _fl in cands:
            res = _pack_grouped(
                radius, counts, cls, row, col, n, K, BT,
                allow_runs=allow_runs, max_windows=max_windows,
            )
            if res is not None and (
                best is None or res["cost"] < best["cost"]
            ):
                best = res
        return best
    radius, floor_p = min(
        ((r, f) for r, f in cands if f <= 1.05 * best_floor),
        key=lambda rf: (rf[0] is None, rf[0] or 0),
    )
    return _pack_grouped(
        radius, counts, cls, row, col, n, K, BT,
        allow_runs=allow_runs, max_windows=max_windows,
    )


def _choose_slot_packing(row, col, T, K, *, ensure_tiles,
                         allow_runs, max_windows=SUBLANES,
                         allow_relax=True, tbl=None):
    """Slot-pack with contiguous-range windows, relaxing the layout when
    the baseline pack sits far from the capacity floor:

    - chunks >> lane-conflict floor: the 8-segment window range binds →
      try deep windows (depth 16/32; r2 grows to 5 bits, the kernel
      selects among depth/8 slabs).

    Candidates are ranked by chunks x modeled cycles/chunk; free
    8-window tables remain the fallback when even the relaxed contig
    packs land far off the floor. Superchunk window sharing (group > 1)
    never reduced chunks and cost fill, so groups are not tried; lane
    rotation was pruned (see the _CYC_SLAB note). Returns
    (packed, contig, run_len, depth, rot) with rot always 1.
    """
    order, ts, lrs, sgs, qs = _sort_entries(row, col)
    ctx = (order, lrs, qs)
    if tbl is None:
        tbl = _lane_count_table(row, T)
    # contig-8 is the baseline: each extra (8,128) slab of a deeper
    # window costs per chunk (_CYC_SLAB), and window-slack streams pack
    # the same chunk count at depth 8, so they never escalate past the
    # first pack.
    first_d = max_windows if not allow_relax else SUBLANES
    pk_c = _pack_slots_entries(
        ts, lrs, sgs, qs, T, ensure_tiles=ensure_tiles,
        max_windows=first_d, contig=True,
    )
    best = (pk_c, True, first_d, 1)
    best_cost = len(pk_c[4]) * _cyc_per_chunk(first_d, 1)
    floor1 = max(_lane_floor_chunks(tbl), 1)
    size_floor = max(_tile_size_floor(tbl), 1)

    # deeper windows: only worth packing when the baseline pack is
    # window-bound (above its own lane floor; the 1.05 trigger is tight
    # because under the round-4 lazy-store kernel chunk count, not
    # per-chunk datapath, dominates — the random-band pack was 10%
    # window-bound at deep-16 and the old 1.15 trigger never fired)
    depths = []
    if allow_relax and len(pk_c[4]) > 1.05 * floor1:
        depths = [2 * SUBLANES, 4 * SUBLANES]

    for d in depths:
        # the relaxed floor bounds what this candidate could achieve;
        # skip the (host-costly) pack when even that loses
        fl = max(floor1, size_floor)
        if fl * _cyc_per_chunk(d) >= best_cost:
            continue
        pk = _pack_slots_entries(
            ts, lrs, sgs, qs, T, ensure_tiles=ensure_tiles,
            max_windows=d, contig=True,
        )
        cost = len(pk[4]) * _cyc_per_chunk(d)
        if cost < best_cost:
            best, best_cost = (pk, True, d, 1), cost

    if best_cost > floor1 * _CYC_DISTINCT:
        pk_d = _pack_slots_entries(
            ts, lrs, sgs, qs, T, ensure_tiles=ensure_tiles,
            max_windows=max_windows,
        )
        if len(pk_d[4]) * _CYC_DISTINCT < best_cost:
            best = (pk_d, False, SUBLANES, 1)
    # at K=128 run batching no longer pays for its run padding — runs
    # only win at small K, where per-chunk flush cost is unamortized
    # (measured on the TPU reference; see the reference file)
    run_len = 4 if allow_runs and K % 4 == 0 and K < 128 else 1
    return best[0], best[1], run_len, best[2], best[3], ctx


def _pad_tile_runs(chunk_tiles, windows, nwin, run):
    """Pad every tile's chunk count to a ``run`` multiple (empty chunks
    contribute zeros) so kernel runs never straddle tiles. Assumes
    chunk_tiles is tile-sorted; preserves intra-tile order. Returns the
    (per-chunk) remap vector WITHOUT applying it to the entry stream —
    the caller composes it with the block-padding remap so the 77M+
    entry array is gathered once, not twice."""
    C0 = len(chunk_tiles)
    if C0 == 0 or run <= 1:
        return None, chunk_tiles, windows, nwin
    uniq, start = np.unique(chunk_tiles, return_index=True)
    cnt = np.diff(np.append(start, C0))
    padded = -(-cnt // run) * run
    new_start = np.concatenate([[0], np.cumsum(padded)])
    # remap original chunk ids into the padded layout
    tile_rank = np.searchsorted(uniq, chunk_tiles)
    remap = new_start[tile_rank] + (np.arange(C0) - start[tile_rank])
    C = int(new_start[-1])
    new_tiles = np.repeat(uniq, padded)
    new_windows = np.zeros((C, SUBLANES), np.int32)
    new_windows[remap] = windows
    new_nwin = np.zeros(C, np.int32)
    new_nwin[remap] = nwin
    return remap.astype(np.int32), new_tiles, new_windows, new_nwin


def group_pad(chunk_tiles, K, BT, *, min_one_step=True):
    """Pad the chunk stream so each K-chunk grid step stays inside one
    BT-tile output block. Returns (remap, C, blocks_per_chunk_padded).

    ``min_one_step=False`` leaves blocks with no chunks unvisited — only
    valid for accumulating streams whose output aliases an already-
    initialized y."""
    C0 = len(chunk_tiles)
    blocks = chunk_tiles // BT
    nb = int(blocks[-1]) + 1 if C0 else 1
    cnt = np.bincount(blocks, minlength=nb)
    padded = -(-cnt // K) * K
    if min_one_step:
        padded = np.maximum(padded, K)
    old_start = np.concatenate([[0], np.cumsum(cnt)])
    new_start = np.concatenate([[0], np.cumsum(padded)])
    remap = new_start[blocks] + (np.arange(C0) - old_start[blocks])
    C = int(new_start[-1])
    blk_full = np.repeat(np.arange(nb, dtype=np.int32), padded)
    return remap, C, blk_full


def build_bell2_plan(
    csr: CSR,
    *,
    dtype=np.float32,
    chunks_per_step: int | None = None,
    tiles_per_block: int | None = None,
    diag_threshold: int = DIAG_THRESHOLD,
    cover_all_tiles: bool = True,
    allow_runs: bool = True,
    allow_relax: bool = True,
    force_slot: bool = False,
) -> Bell2Plan:
    """Vectorized plan construction (O(nnz log nnz) + O(#subrows)).

    ``cover_all_tiles=False`` builds a sparse *accumulating* stream: tiles
    without nonzeros get no chunks at all, so the kernel must run with its
    output aliased to an already-initialized y (the far-stream mode).
    """
    rowlen = np.diff(csr.indptr)
    row = np.repeat(np.arange(csr.nrows, dtype=np.int32), rowlen)
    return build_bell2_from_arrays(
        csr.nrows, csr.ncols, row, np.asarray(csr.indices, np.int32),
        np.asarray(csr.data), dtype=dtype,
        chunks_per_step=chunks_per_step, tiles_per_block=tiles_per_block,
        diag_threshold=diag_threshold, cover_all_tiles=cover_all_tiles,
        allow_runs=allow_runs, allow_relax=allow_relax,
        force_slot=force_slot,
    )


def build_bell2_from_arrays(
    n: int,
    m: int,
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    *,
    dtype=np.float32,
    chunks_per_step: int | None = None,
    tiles_per_block: int | None = None,
    diag_threshold: int = DIAG_THRESHOLD,
    cover_all_tiles: bool = True,
    allow_runs: bool = True,
    allow_relax: bool = True,
    val2: np.ndarray | None = None,
    force_slot: bool = False,
) -> Bell2Plan:
    """Plan construction straight from COO-like triples, in ANY entry
    order and with duplicates forbidden — the packer performs its own
    (tile, seg, q) sort, so callers holding raw triples (e.g. the
    symmetric far stream's mirrored concatenation) skip a full
    canonicalize sort + CSR build over the whole entry set.

    ``force_slot`` bypasses the unit-pipeline predictor so the plan is
    always slot-packed with contiguous windows — required by consumers
    that need the word-path kernel contract (the double-float fp64
    path, ``ops/bell2_df``: banded matrices would otherwise take the
    unit pipeline, whose free window tables are not word-eligible).
    """
    nnz = len(row)
    auto_k, auto_bt = auto_geometry(n, nnz)
    K = chunks_per_step or auto_k
    BT = tiles_per_block or auto_bt
    T = max(1, -(-n // LANES))
    x_rows = max(1, -(-m // LANES))

    if nnz == 0:
        return _empty_plan(
            n, m, T, x_rows, dtype, K, BT, cover=cover_all_tiles
        )

    with trace.span("cfs.plan.predict", log=True, nnz=nnz):
        # int32 entry streams halve the planner's live set; the slot
        # packer's sorted context is int32 regardless of input dtype, so
        # coordinates beyond int32 are rejected rather than silently
        # wrapped (n*m/128 must also fit the int64 sort key)
        if max(n, m) >= (1 << 31):
            raise ValueError(
                f"matrix {n}x{m} exceeds the planner's int32 coordinate "
                "range"
            )
        row = np.asarray(row)
        col = np.asarray(col)
        idt = (
            np.int32
            if row.dtype == np.int32 and col.dtype == np.int32
            else np.int64
        )
        row = np.ascontiguousarray(row, idt)
        col = np.ascontiguousarray(col, idt)
        val = np.asarray(val)

        tile = row >> 7
        seg = col >> 7
        # lane/q are derived on demand: the slot path takes them from the
        # packer's sorted context, the unit path from plan_units

        # cheap scatter predictor: few entries per (tile, segment) means
        # unit-based subrows would sit mostly empty — go straight to the
        # conflict-aware slot packer and skip two full sort pipelines
        slot_ok = _native.available() or nnz <= 2_000_000 or force_slot
        if force_slot:
            # straight to the conflict-aware slot packer — skip the
            # predictor entirely (its distinct-count is costly on big
            # streams)
            avg_per_ts = 0.0
        else:
            key_space = T * (x_rows + 1)
            kdt = (
                np.int32
                if tile.dtype == np.int32 and key_space < (1 << 31)
                else np.int64
            )
            ts_key = tile.astype(kdt, copy=True)
            ts_key *= kdt(x_rows + 1)
            ts_key += seg.astype(kdt, copy=False)
            if key_space <= max(4 * nnz, 1 << 26):
                # distinct-count via boolean scatter: two O(nnz) passes
                # instead of a full sort (np.unique) — the predictor was
                # costing more than the decision it informs on big matrices
                present = np.zeros(key_space, bool)
                present[ts_key] = True
                n_ts = int(np.count_nonzero(present))
            else:
                n_ts = len(np.unique(ts_key))
            del ts_key
            avg_per_ts = nnz / max(n_ts, 1)
        if slot_ok and avg_per_ts >= 24:
            # dense tile-segments still slot-pack better when the entries
            # sit on SPARSE exact diagonals (block structure at random
            # offsets — the audikw shape): sample the diagonal density
            # instead of paying the full unit pipeline and its retry
            samp = slice(None)
            if nnz > 2_000_000:
                samp = np.random.default_rng(0).integers(0, nnz, 1_000_000)
            dk = (
                tile[samp] * np.int64(1 << 33)
                + (row[samp] - col[samp]) + np.int64(1 << 32)
            )
            _, dc = np.unique(dk, return_counts=True)
            scale = nnz / max(
                len(dk) if isinstance(samp, np.ndarray) else nnz, 1
            )
            # a diagonal is certified dense only with >= 4 sampled hits:
            # once scale alone exceeds the threshold (nnz >= 48M at the 1M
            # sample), a SINGLE hit — which every tiny block diagonal gets
            # — would certify it, flipping huge scattered matrices onto the
            # unit pipeline (a large preprocessing cost at audikw_1 scale)
            diag_frac = float(
                dc[(dc >= 4) & (dc * scale >= diag_threshold)].sum()
                / max(len(dk), 1)
            )
            if diag_frac < 0.5:
                avg_per_ts = 0.0  # force the slot packer
        # full 8 windows: caps of 4/6 saved loads but cost 14% more
        # chunks at scale (fill dominates); keep the knob, default 8
        slot_windows = SUBLANES
        packed_alt = None
        contig = False
        depth, rot = SUBLANES, 1
    with trace.span("cfs.plan.layout", log=True):
        row_perm = None
        unperm = None
        pack_ctx = None
        if slot_ok and avg_per_ts < 24:
            grp = None
            tbl = _lane_count_table(row, T)
            if allow_relax:
                strict_floor = max(_lane_floor_chunks(tbl), 1)
                size_floor = max(_tile_size_floor(tbl), 1)
                if strict_floor > 1.15 * size_floor:
                    grp = _try_degree_grouping(
                        row, col, n, K, BT, allow_runs=allow_runs,
                        max_windows=slot_windows, strict_floor=strict_floor,
                    )
            if grp is not None and grp["cost"] < strict_floor * _CYC_CONTIG:
                # the grouped pack beats anything the in-order layout could
                # reach (its lane floor at the cheapest datapath) — adopt
                # without paying a second packing pass
                packed_alt = grp["pk"]
                contig, run_pick = grp["contig"], grp["run_pick"]
                depth, rot = grp["depth"], grp["rot"]
                pack_ctx = grp["ctx"]
            else:
                packed_alt, contig, run_pick, depth, rot, pack_ctx = (
                    _choose_slot_packing(
                        row, col, T, K,
                        ensure_tiles=cover_all_tiles,
                        allow_runs=allow_runs, max_windows=slot_windows,
                        allow_relax=allow_relax, tbl=tbl,
                    )
                )
                # 1.1: prefer the grouped layout on near-ties — on the TPU
                # reference irregular in-order streams ran above the modeled
                # per-chunk cost, so fewer chunks win ties
                if grp is not None and grp["cost"] < 1.1 * len(
                    packed_alt[4]
                ) * _cyc_per_chunk(depth, rot):
                    packed_alt = grp["pk"]
                    contig, run_pick = grp["contig"], grp["run_pick"]
                    depth, rot = grp["depth"], grp["rot"]
                    pack_ctx = grp["ctx"]
                else:
                    grp = None
            if grp is not None:
                T, row_perm, unperm = grp["T"], grp["perm"], grp["unperm"]
                # global compaction packs a dense tile prefix; radius mode
                # keeps a sparse grid (skipped blocks read 0 via sentinel)
                cover_all_tiles = grp["radius"] is None
                info(
                    "bell2: degree-grouped rows (radius=%s) -> %d tiles, "
                    "%d chunks", grp["radius"], T, len(packed_alt[4]),
                )
        run_len = 1
        wmax = SUBLANES
        e_rc = None
        run_remap = None  # run padding's chunk remap, composed at assembly
        if packed_alt is not None:
            info(
                "bell2: slot packing (%.1f nnz per tile-seg, contig=%s, "
                "depth=%d, rot=%d)",
                avg_per_ts, contig, depth, rot,
            )
            e_chunk, e_sub, e_r2, e_rc, chunk_tiles, windows, nwin = packed_alt
            if allow_runs:
                wmax = slot_windows  # static; pinned to 8 for SPMD plans
            if run_pick > 1:
                # runs batch same-tile chunks: one flush per run
                run_len = run_pick
                (run_remap, chunk_tiles, windows, nwin) = _pad_tile_runs(
                    chunk_tiles, windows, nwin, run_len
                )
        else:
            unit_key, tile, lane, q, seg = plan_units(
                row, col, nnz, diag_threshold
            )
            e_chunk, e_sub, e_r2, chunk_tiles, windows, nwin = pack_chunks(
                unit_key, tile, seg, T, ensure_tiles=cover_all_tiles
            )
            pad0 = len(chunk_tiles) * SUBLANES * LANES / max(nnz, 1)
            if pad0 > 1.7 and slot_ok:
                # mispredicted: retry with the slot packer (and the
                # degree-grouped layout) and keep the cheapest plan
                tbl_r = _lane_count_table(row, T)
                alt, contig_a, run_pick, depth_a, rot_a, ctx_a = (
                    _choose_slot_packing(
                        row, col, T, K, ensure_tiles=cover_all_tiles,
                        allow_runs=allow_runs, max_windows=slot_windows,
                        allow_relax=allow_relax, tbl=tbl_r,
                    )
                )
                cand = None
                if alt is not None and len(alt[4]) < len(chunk_tiles):
                    cand = (alt, contig_a, run_pick, depth_a, rot_a, None,
                            ctx_a)
                if allow_relax:
                    grp = _try_degree_grouping(
                        row, col, n, K, BT, allow_runs=allow_runs,
                        max_windows=slot_windows,
                        strict_floor=max(_lane_floor_chunks(tbl_r), 1),
                    )
                    if (
                        grp is not None
                        and len(grp["pk"][4]) < len(chunk_tiles)
                        and (
                            cand is None
                            # 1.1: same grouped near-tie preference as the
                            # main branch (see above)
                            or grp["cost"] < 1.1 * len(cand[0][4])
                            * _cyc_per_chunk(cand[3], cand[4])
                        )
                    ):
                        cand = (
                            grp["pk"], grp["contig"], grp["run_pick"],
                            grp["depth"], grp["rot"], grp, grp["ctx"],
                        )
                if cand is not None:
                    (alt, contig_a, run_pick, depth_a, rot_a, grp_pick,
                     pack_ctx) = cand
                    info(
                        "bell2: slot packing %d -> %d chunks (contig=%s, "
                        "depth=%d, rot=%d, grouped=%s)",
                        len(chunk_tiles), len(alt[4]), contig_a, depth_a,
                        rot_a, grp_pick is not None,
                    )
                    (e_chunk, e_sub, e_r2, e_rc, chunk_tiles, windows,
                     nwin) = alt
                    contig = contig_a
                    depth, rot = depth_a, rot_a
                    if grp_pick is not None:
                        T = grp_pick["T"]
                        row_perm = grp_pick["perm"]
                        unperm = grp_pick["unperm"]
                        cover_all_tiles = grp_pick["radius"] is None
                    if allow_runs:
                        wmax = slot_windows
                    if run_pick > 1:
                        run_len = run_pick
                        (run_remap, chunk_tiles, windows,
                         nwin) = _pad_tile_runs(
                            chunk_tiles, windows, nwin, run_len
                        )
                else:
                    depth, rot = SUBLANES, 1

    with trace.span("cfs.plan.assemble", log=True):
        if not contig:
            depth, rot = SUBLANES, 1
        else:
            # the contig kernel loads x rows [w0, w0+depth); enlarge the
            # gather space to >= depth rows and clamp w0 so the slab stays
            # in bounds (r2 shifts up by the same amount — still < depth
            # since the top real segment is x_rows-1)
            x_rows = max(x_rows, depth)
            w0 = windows[:, 0].astype(np.int64)
            delta = np.maximum(0, w0 - (x_rows - depth))
            if delta.any():
                # e_chunk is in pre-run-padding space; pull the per-chunk
                # delta back through the (small) run remap
                dvec = delta if run_remap is None else delta[run_remap]
                e_r2 = e_r2 + dvec.astype(e_r2.dtype)[e_chunk]
                base = (w0 - delta).astype(np.int32)
                windows = base[:, None] + np.arange(
                    SUBLANES, dtype=np.int32
                )[None, :]
                nwin = np.minimum(
                    nwin.astype(np.int64) + delta, SUBLANES
                ).astype(np.int32)

        if pack_ctx is not None:
            # slot-packed plans live in the packer's sorted entry domain:
            # bring lane/q/val there with ONE value gather instead of four
            # random scatter-backs per packing candidate (same slots are
            # written either way — the plan arrays are bit-identical)
            order_p, lane, q = pack_ctx
            val = np.asarray(val)[order_p]
            if val2 is not None:
                val2 = np.asarray(val2)[order_p]
            del row, col, tile, seg, pack_ctx, order_p  # dead entry streams

        remap, C, blk_full = group_pad(
            chunk_tiles, K, BT, min_one_step=cover_all_tiles
        )
        meta = np.zeros((C, META_W), np.int32)
        meta[remap, 0] = (chunk_tiles % BT).astype(np.int32)
        meta[remap, 1] = nwin
        meta[remap, 2:] = windows
        # forward-fill K-padding chunks' meta from the last REAL chunk of
        # the same block: the lazy-store kernels overwrite row ``sub`` with
        # a register accumulator that resets on sub change, so a padding
        # chunk pointing at sub 0 would wipe that row — pointing at the
        # block's last real sub makes it a harmless re-store of the same
        # value (its slots are all zero). Blocks without a real chunk keep
        # zeros (only all-empty streams, which never run the lazy path).
        written = np.zeros(C, bool)
        written[remap] = True
        if C and not written.all():
            src = np.maximum.accumulate(np.where(written, np.arange(C), -1))
            fill = ~written & (src >= 0) & (blk_full == blk_full[src])
            meta[fill] = meta[src[fill]]
        step_block = blk_full[::K].copy()

        vals_arr = np.zeros((C, SUBLANES, LANES), dtype)
        # one-sided streams need only q (7 bits) + r2 (<= 5 bits) + rc
        # (<= 2 bits): int16 halves the index traffic (the paired symmetric
        # layout needs 18 bits and stays int32). All scatters hit unique
        # slots (each entry owns its placed lane; gather lanes carry one
        # window index per subrow). The native assembler does the whole
        # job in one entry pass; the NumPy scatters below are its
        # bit-identical fallback.
        packed = np.zeros((C, SUBLANES, LANES), np.int16)
        cr = remap.astype(np.int32)
        if run_remap is not None:
            cr = cr[run_remap]  # compose: pre-pad chunk -> final chunk
        ec = cr[e_chunk]
        val_c = np.ascontiguousarray(np.asarray(val, dtype))
        if not _native.assemble_plan(
            ec, e_sub, e_r2, e_rc if e_rc is not None else e_r2,
            lane, q, val_c, rot, vals_arr, packed,
        ):
            # with lane rotation the entry occupies its PLACED lane (its
            # coset lane chosen by the packer); rc rides bits 12-13 of the
            # packed field so the kernel can mask per rotation group
            lane_p = (
                lane if rot == 1 else (lane + (LANES // rot) * e_rc) & 127
            )
            vals_arr[ec, e_sub, lane_p] = val_c
            if rot == 1:
                packed[ec, e_sub, lane_p] = np.asarray(q, np.int16)
            else:
                packed[ec, e_sub, lane_p] = (q | (e_rc << 12)).astype(np.int16)
            packed[ec, e_sub, q] |= (e_r2 << 7).astype(np.int16)
        vals2_arr = None
        if val2 is not None:
            # second value plane (df lo halves): same slot layout, one
            # scatter (rot is always 1 — rotation was pruned)
            vals2_arr = np.zeros((C, SUBLANES, LANES), np.float32)
            vals2_arr[ec, e_sub, lane] = np.ascontiguousarray(
                np.asarray(val2, np.float32)
            )

        plan = Bell2Plan(
            n, m, nnz,
            vals_arr.reshape(C * SUBLANES, LANES),
            packed.reshape(C * SUBLANES, LANES),
            meta, step_block,
            T, x_rows, K, BT, run_len, wmax, contig,
            window_depth=depth, lane_rot=rot,
            sparse_stream=not cover_all_tiles,
            row_perm=row_perm,
            unperm_pk=None if unperm is None else unperm[0],
            unperm_slabs=None if unperm is None else unperm[1],
            vals2=None if vals2_arr is None
            else vals2_arr.reshape(C * SUBLANES, LANES),
        )
    info(
        "bell2: %dx%d nnz=%d chunks=%d pad=%.2fx",
        n, m, nnz, C, plan.padding_ratio,
    )
    return plan


def build_general_plan(
    csr: CSR,
    *,
    dtype=np.float32,
    dia: bool = True,
    chunks_per_step: int | None = None,
    tiles_per_block: int | None = None,
) -> Bell2Plan:
    """General-matrix plan: peel dense signed-offset diagonals into an
    index-free SDIA stream (square matrices), the residual into BELL2.

    The general analog of the symmetric SDIA peel in
    ``build_sbell_plan`` — banded/stencil GENERAL matrices get the same
    index-free fast path the symmetric ones do (VERDICT r1: the general
    path previously always paid the one-sided gather stream).
    """
    from .sdia import extract_sdia

    if not (dia and csr.nrows == csr.ncols and csr.nnz):
        return build_bell2_plan(
            csr, dtype=dtype, chunks_per_step=chunks_per_step,
            tiles_per_block=tiles_per_block,
        )
    rowlen = np.diff(csr.indptr)
    row = np.repeat(np.arange(csr.nrows, dtype=np.int32), rowlen)
    col = np.asarray(csr.indices, np.int32)
    val = np.asarray(csr.data)
    # peel acceptance gate: the blocked-y SDIA kernel scans ALL of x/y
    # regardless of how few diagonals it carries, while folding a thin
    # peel back into the one-sided stream costs only its chunk share. A
    # peel must carry enough of the matrix to amortize the scan — below
    # ~25% of nnz the far stream exists anyway and the extra pass is a
    # net loss. The gate runs INSIDE extract_sdia on the per-offset
    # counts, before the (R, D, 8, 128) planes are allocated.
    dia_plan, resid = extract_sdia(
        row, col, val, csr.nrows, dtype=dtype, signed=True,
        min_frac=SDIA_PEEL_MIN_FRAC,
    )
    if dia_plan is None:
        return build_bell2_plan(
            csr, dtype=dtype, chunks_per_step=chunks_per_step,
            tiles_per_block=tiles_per_block,
        )
    from .coo import COO

    rcsr = CSR.from_coo(
        COO(csr.nrows, csr.ncols, row[resid], col[resid], val[resid])
    )
    # the post-peel residual is sparse in tiles: build it accumulating
    # so empty tiles get no covering chunks (they would cost as much
    # stream traffic as the diagonals themselves on stencil matrices)
    plan = build_bell2_plan(
        rcsr, dtype=dtype, chunks_per_step=chunks_per_step,
        tiles_per_block=tiles_per_block, cover_all_tiles=False,
    )
    plan.dia = dia_plan
    return plan


def _empty_plan(n, m, T, x_rows, dtype, K, BT, cover=True):
    if cover:
        chunk_tiles = np.arange(T, dtype=np.int64)
        remap, C, blk_full = group_pad(chunk_tiles, K, BT)
        meta = np.zeros((C, META_W), np.int32)
        meta[remap, 0] = (chunk_tiles % BT).astype(np.int32)
        step_block = blk_full[::K].copy()
    else:
        # sparse (accumulating) empty stream: one zero step is enough —
        # the apply layer skips the kernel entirely (has_work=False)
        C = K
        meta = np.zeros((C, META_W), np.int32)
        step_block = np.zeros(1, np.int32)
    return Bell2Plan(
        n, m, 0,
        np.zeros((C * SUBLANES, LANES), dtype),
        np.zeros((C * SUBLANES, LANES), np.int16),
        meta, step_block, T, x_rows, K, BT,
        sparse_stream=not cover,
    )
