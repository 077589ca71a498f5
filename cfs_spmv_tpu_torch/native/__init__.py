"""Native host-runtime bindings (C++ via ctypes).

Host copy of ``cfs_spmv_tpu/native/__init__.py`` for the PyTorch port.
It binds the SAME source, the repository's shared ``csrc/cfs_native.cpp``
(read, never copied): the inherently sequential host-side scans — MMF
tokenizing (ref ``src/mmf.cpp:6-44``) and greedy BELL2 chunk packing
(the planner loop replacing per-thread CSR splitting,
``csr_matrix.tpp:1204-1348``) — compiled into a C-ABI shared library.

The library is built on first use with the system ``g++`` (cached in
``$CFS_NATIVE_CACHE`` or ``build/native/`` at the repository root) and
loaded with ctypes; every entry point has a NumPy fallback in its
caller, bit-identical by the invariant ``tests/test_native.py`` holds, so
an environment without a toolchain still works (``CFS_NATIVE=0`` forces
the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from ..utils.config import env_flag
from ..utils.logging import info

__all__ = ["available", "parse_mmf_body", "pack_units"]

_lock = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "cfs_native.cpp",
)


def _cache_dir() -> str:
    d = os.environ.get("CFS_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(_SRC)), "build", "native"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    """Compile csrc/cfs_native.cpp, content-addressed in the cache dir."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libcfs_native-{tag}.so")
    if os.path.exists(out):
        return out
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", out + ".tmp", _SRC,
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(out + ".tmp", out)
    except (OSError, subprocess.SubprocessError) as e:
        print(
            f"cfs_spmv_tpu_torch: native build failed ({e}); using NumPy "
            "fallbacks",
            file=sys.stderr,
        )
        return None
    info("native: built %s", out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not env_flag("CFS_NATIVE", True):
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.cfs_parse_mmf_body.restype = ctypes.c_int64
        lib.cfs_parse_mmf_body.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, i64p, i64p, f64p,
        ]
        lib.cfs_pack_units.restype = ctypes.c_int64
        lib.cfs_pack_units.argtypes = [
            i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i32p, i32p,
        ]
        lib.cfs_pack_slots.restype = ctypes.c_int64
        lib.cfs_pack_slots.argtypes = [
            i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i32p, i32p,
        ]
        lib.cfs_pack_slots_i32.restype = ctypes.c_int64
        lib.cfs_pack_slots_i32.argtypes = [
            i32p, i32p, i32p, i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            i32p, i32p, i32p, i32p, i64p, i32p, i32p,
        ]
        lib.cfs_pack_slots_sweep.restype = ctypes.c_int64
        lib.cfs_pack_slots_sweep.argtypes = [
            i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p, i64p, i32p, i32p,
        ]
        lib.cfs_pack_slots_sweep_i32.restype = ctypes.c_int64
        lib.cfs_pack_slots_sweep_i32.argtypes = [
            i32p, i32p, i32p, i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32p, i32p, i32p, i32p, i64p, i32p, i32p,
        ]
        lib.cfs_assemble_plan.restype = None
        lib.cfs_assemble_plan.argtypes = [
            i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, i16p,
        ]
        lib.cfs_assemble_sdia.restype = None
        lib.cfs_assemble_sdia.argtypes = [
            i64p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.cfs_pair_mark.restype = ctypes.c_int64
        lib.cfs_pair_mark.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int64, u8p,
            ctypes.c_int64, i32p, u8p,
        ]
        lib.cfs_dist_sym_count.restype = ctypes.c_int64
        lib.cfs_dist_sym_count.argtypes = [
            i64p, i32p, ctypes.c_int64, ctypes.c_int64, i64p,
            ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p,
        ]
        lib.cfs_dist_sym_fill.restype = None
        lib.cfs_dist_sym_fill.argtypes = [
            i64p, i32p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p,
            i32p, i32p, ctypes.c_void_p,
            i32p, i32p, ctypes.c_void_p,
            i32p, i32p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.cfs_sym_adjacency.restype = None
        lib.cfs_sym_adjacency.argtypes = [
            i64p, i32p, ctypes.c_int64, i64p, i32p,
        ]
        lib.cfs_sym_off_counts.restype = ctypes.c_int64
        lib.cfs_sym_off_counts.argtypes = [
            i64p, i32p, ctypes.c_int64, i64p, i64p,
        ]
        lib.cfs_sym_split_fill.restype = ctypes.c_int64
        lib.cfs_sym_split_fill.argtypes = [
            i64p, i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, i32p, i32p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_mmf_body(body: bytes, nnz: int, width: int):
    """Tokenize an MMF coordinate body natively.

    Returns (row, col, val) int64/int64/float64 arrays (val is zeros for
    width == 2 pattern files), or None when the native library is absent
    or the body is malformed (caller falls back to NumPy parsing).
    """
    lib = _load()
    if lib is None:
        return None
    row = np.empty(nnz, np.int64)
    col = np.empty(nnz, np.int64)
    val = np.zeros(nnz, np.float64)
    got = lib.cfs_parse_mmf_body(
        body, len(body), nnz, width, row, col, val
    )
    if got != nnz:
        return None
    return row, col, val


def pack_units(uw_start, uw_end, uw_seg, unit_tile, sublanes, max_windows):
    """Greedy chunk/window assignment (see csrc/cfs_native.cpp).

    Returns (chunk_of_unit, subrow_of_unit, uw_slot, chunk_tile, windows,
    nwin) with chunk arrays trimmed to the chunk count, or None when
    native is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n_units = len(unit_tile)
    n_uw = len(uw_seg)
    chunk_of_unit = np.zeros(n_units, np.int64)
    subrow_of_unit = np.zeros(n_units, np.int64)
    uw_slot = np.zeros(max(n_uw, 1), np.int64)
    cap = max(n_units, 1)
    chunk_tile = np.zeros(cap, np.int64)
    windows = np.zeros((cap, sublanes), np.int32)
    nwin = np.zeros(cap, np.int32)
    C0 = lib.cfs_pack_units(
        np.ascontiguousarray(uw_start, np.int64),
        np.ascontiguousarray(uw_end, np.int64),
        np.ascontiguousarray(uw_seg, np.int64),
        np.ascontiguousarray(unit_tile, np.int64),
        n_units, sublanes, max_windows,
        chunk_of_unit, subrow_of_unit, uw_slot,
        chunk_tile, windows, nwin,
    )
    if C0 < 0:
        return None
    return (
        chunk_of_unit, subrow_of_unit, uw_slot[:n_uw],
        chunk_tile[:C0], windows[:C0], nwin[:C0],
    )


def pack_slots(tile, lane_r, seg, lane_c, max_windows, ring=32, group=1,
               contig=False, rot=1):
    """Conflict-aware entry-level packing (csrc cfs_pack_slots).

    Entries must be sorted by (tile, seg, lane_c). Returns per-entry
    (chunk, subrow, r2, rc) and per-chunk (tile, windows, nwin) arrays,
    or None when native is unavailable (caller uses the Python fallback).
    ``group > 1`` packs superchunks of ``group*8`` subrows sharing one
    window table (subrow spans [0, group*8); chunk arrays are per
    superchunk — the caller expands to chunk granularity).
    ``rot > 1`` allows an entry of row lane ``l`` to occupy any lane of
    the coset ``{l, l+128/rot, ...}`` (recorded in rc; the kernel rolls
    each rotation group back) — dense rows stop forcing chunks the other
    lanes cannot fill. With ``contig`` the window range may span up to 32
    segments (r2 is 5 bits in the packed field).
    """
    lib = _load()
    if lib is None:
        return None
    n = len(tile)
    # int32 streams when the caller already holds int32 components
    # (always true for the sorted-context path; < 2^31 rows/cols):
    # halves the packer's memory traffic — the planner's hottest pass
    use32 = all(
        np.asarray(a).dtype == np.int32
        for a in (tile, lane_r, seg, lane_c)
    )
    if use32:
        fn = lib.cfs_pack_slots_i32
        args = (
            np.ascontiguousarray(tile, np.int32),
            np.ascontiguousarray(lane_r, np.int32),
            np.ascontiguousarray(seg, np.int32),
            np.ascontiguousarray(lane_c, np.int32),
        )
        edt = np.int32
    else:
        fn = lib.cfs_pack_slots
        args = (
            np.ascontiguousarray(tile, np.int64),
            np.ascontiguousarray(lane_r, np.int64),
            np.ascontiguousarray(seg, np.int64),
            np.ascontiguousarray(lane_c, np.int64),
        )
        edt = np.int64
    e_chunk = np.zeros(max(n, 1), edt)
    e_sub = np.zeros(max(n, 1), edt)
    e_r2 = np.zeros(max(n, 1), edt)
    e_rc = np.zeros(max(n, 1), edt)
    # per-chunk arrays start at a 32x-padding capacity and retry at the
    # worst case (one chunk per entry) only if exceeded — full-size
    # upfront was multi-GB of untouched zeros at 80M entries
    cap = min(max(n // 32, 4096), max(n, 1))
    while True:
        chunk_tile = np.zeros(cap, np.int64)
        windows = np.zeros((cap, 8), np.int32)
        nwin = np.zeros(cap, np.int32)
        C0 = fn(
            *args, n, max_windows, ring, group, int(contig), rot, cap,
            e_chunk, e_sub, e_r2, e_rc, chunk_tile, windows, nwin,
        )
        if C0 != -2:
            break
        cap = max(n, 1)
    if C0 < 0:
        return None
    # copy the trimmed per-chunk slices so a kept plan never pins the
    # full-capacity base arrays
    return (
        e_chunk[:n], e_sub[:n], e_r2[:n], e_rc[:n],
        chunk_tile[:C0].copy(), windows[:C0].copy(), nwin[:C0].copy(),
    )


def pack_slots_sweep(tile, lane_r, seg, lane_c, max_windows):
    """Anchor-sweep contiguous-window packing (csrc cfs_pack_slots_sweep).

    Entries must be sorted by (tile, seg, lane_c). Each tile is packed by
    anchoring successive chunks at the minimum unassigned segment and
    giving every row lane its maximal window-feasible prefix — optimal
    for the per-lane capacity relaxation (the first-fit ring packer's
    staggered anchors measured +10.5% chunks over the lane floor on the
    random-band shape; the sweep lands within 1 chunk of it). Returns the
    pack_slots output tuple (e_rc all zero), or None when native is
    unavailable (caller uses pack_slots_sweep_py).
    """
    lib = _load()
    if lib is None:
        return None
    n = len(tile)
    use32 = all(
        np.asarray(a).dtype == np.int32
        for a in (tile, lane_r, seg, lane_c)
    )
    if use32:
        fn = lib.cfs_pack_slots_sweep_i32
        args = (
            np.ascontiguousarray(tile, np.int32),
            np.ascontiguousarray(lane_r, np.int32),
            np.ascontiguousarray(seg, np.int32),
            np.ascontiguousarray(lane_c, np.int32),
        )
        edt = np.int32
    else:
        fn = lib.cfs_pack_slots_sweep
        args = (
            np.ascontiguousarray(tile, np.int64),
            np.ascontiguousarray(lane_r, np.int64),
            np.ascontiguousarray(seg, np.int64),
            np.ascontiguousarray(lane_c, np.int64),
        )
        edt = np.int64
    e_chunk = np.zeros(max(n, 1), edt)
    e_sub = np.zeros(max(n, 1), edt)
    e_r2 = np.zeros(max(n, 1), edt)
    e_rc = np.zeros(max(n, 1), edt)
    # chunk count can exceed n: phase-1 planned chunks (<= n) may be
    # drained by phase-2 reuse while their entries land in fallback
    # chunks (also <= n), so the hard bound is 2n; grow to it instead
    # of retrying forever at n
    cap = min(max(n // 32, 4096), max(n, 1))
    cap_max = 2 * max(n, 1) + 16
    while True:
        chunk_tile = np.zeros(cap, np.int64)
        windows = np.zeros((cap, 8), np.int32)
        nwin = np.zeros(cap, np.int32)
        C0 = fn(
            *args, n, max_windows, cap,
            e_chunk, e_sub, e_r2, e_rc, chunk_tile, windows, nwin,
        )
        if C0 != -2:
            break
        if cap >= cap_max:
            return None  # cannot happen by the 2n bound; fail safe
        cap = cap_max if cap >= max(n, 1) else max(n, 1)
    if C0 < 0:
        return None
    return (
        e_chunk[:n], e_sub[:n], e_r2[:n], e_rc[:n],
        chunk_tile[:C0].copy(), windows[:C0].copy(), nwin[:C0].copy(),
    )


class _SweepChunk:
    __slots__ = ("id", "anchor", "nw", "used", "cseg")

    def __init__(self, cid, anchor):
        self.id = cid
        self.anchor = anchor
        self.nw = 1
        self.used = [set() for _ in range(8)]   # subrow -> row lanes
        self.cseg = [dict() for _ in range(8)]  # subrow -> {q: seg}

    def try_place(self, lr, lc, sg):
        # reuse-first: a subrow whose gather lane already maps to this
        # segment shares the slot (no new q capacity); then any subrow
        # with the gather lane free (matches SweepChunk::try_place)
        for s in range(8):
            if self.cseg[s].get(lc) != sg or lr in self.used[s]:
                continue
            self.used[s].add(lr)
            w = sg - self.anchor
            self.nw = max(self.nw, w + 1)
            return s, w
        for s in range(8):
            if lc in self.cseg[s] or lr in self.used[s]:
                continue
            self.used[s].add(lr)
            self.cseg[s][lc] = sg
            w = sg - self.anchor
            self.nw = max(self.nw, w + 1)
            return s, w
        return None


def pack_slots_sweep_py(tile, lane_r, seg, lane_c, max_windows):
    """Pure-Python mirror of cfs_pack_slots_sweep (bit-identical).

    Phase 1 per tile: relaxed anchor sweep (per-lane quota 8 per chunk,
    window feasibility only). Phase 2: open every planned chunk, first-fit
    each entry across the chunks whose window contains its segment
    (q-conflicts retry the next chunk); fallback chunks anchored at the
    failing entry's segment append after the planned list.
    """
    D = max_windows
    n = len(tile)
    tile = np.asarray(tile)
    lane_r = np.asarray(lane_r)
    seg = np.asarray(seg)
    lane_c = np.asarray(lane_c)
    e_chunk = np.zeros(n, np.int64)
    e_sub = np.zeros(n, np.int64)
    e_r2 = np.zeros(n, np.int64)
    e_rc = np.zeros(n, np.int64)
    chunk_tiles: list[int] = []
    win_list: list[tuple[int, int]] = []  # (anchor, min(nw, 8)) per chunk
    rdone = np.zeros(n, bool)
    i = 0
    while i < n:
        t = int(tile[i])
        j = i
        while j < n and int(tile[j]) == t:
            j += 1
        # phase 1: relaxed anchor plan
        anchors = []
        first = i
        while first < j:
            a = int(seg[first])
            anchors.append(a)
            lane_taken = [0] * 128
            for k in range(first, j):
                if int(seg[k]) - a >= D:
                    break
                if rdone[k]:
                    continue
                lr = int(lane_r[k])
                if lane_taken[lr] >= 8:
                    continue
                rdone[k] = True
                lane_taken[lr] += 1
            while first < j and rdone[first]:
                first += 1
        # phase 2: all planned chunks open at once
        base = len(chunk_tiles)
        chunks = [_SweepChunk(base + c, a) for c, a in enumerate(anchors)]
        F = len(chunks)
        lo, hi, flo = 0, -1, F
        for k in range(i, j):
            sg = int(seg[k])
            lr = int(lane_r[k])
            lc = int(lane_c[k])
            while lo < F and chunks[lo].anchor + D <= sg:
                lo += 1
            while hi + 1 < F and chunks[hi + 1].anchor <= sg:
                hi += 1
            while flo < len(chunks) and chunks[flo].anchor + D <= sg:
                flo += 1
            placed = None
            for c in range(lo, hi + 1):
                placed = chunks[c].try_place(lr, lc, sg)
                if placed is not None:
                    e_chunk[k], e_sub[k], e_r2[k] = (
                        chunks[c].id, placed[0], placed[1]
                    )
                    break
            if placed is None:
                for c in range(flo, len(chunks)):
                    if chunks[c].anchor > sg:
                        break
                    placed = chunks[c].try_place(lr, lc, sg)
                    if placed is not None:
                        e_chunk[k], e_sub[k], e_r2[k] = (
                            chunks[c].id, placed[0], placed[1]
                        )
                        break
            if placed is None:
                ch = _SweepChunk(base + len(chunks), sg)
                ch.used[0].add(lr)
                ch.cseg[0][lc] = sg
                chunks.append(ch)
                e_chunk[k], e_sub[k], e_r2[k] = ch.id, 0, 0
        for ch in chunks:
            chunk_tiles.append(t)
            win_list.append((ch.anchor, min(ch.nw, 8)))
        i = j
    C0 = len(chunk_tiles)
    windows = np.zeros((max(C0, 1), 8), np.int32)
    nwin = np.zeros(max(C0, 1), np.int32)
    for ci, (w0, nv) in enumerate(win_list):
        windows[ci, :nv] = w0 + np.arange(nv, dtype=np.int32)
        nwin[ci] = nv
    return (
        e_chunk, e_sub, e_r2, e_rc,
        np.asarray(chunk_tiles, np.int64), windows[:C0], nwin[:C0],
    )


def pack_slots_py(tile, lane_r, seg, lane_c, max_windows, ring=32, group=1,
                  contig=False, rot=1):
    """Pure-Python mirror of cfs_pack_slots (CI fallback; slow)."""
    n = len(tile)
    nsub = 8 * group
    stride = 128 // rot
    e_chunk = np.zeros(n, np.int64)
    e_sub = np.zeros(n, np.int64)
    e_r2 = np.zeros(n, np.int64)
    e_rc = np.zeros(n, np.int64)
    chunk_tile: list[int] = []
    wl_by_id: dict[int, list[int]] = {}
    open_ids: list[int] = []  # oldest first
    state: dict[int, tuple] = {}  # id -> (used lanes sets, cseg dicts)
    cur_tile = None
    for i in range(n):
        t, lr, sg, lc = int(tile[i]), int(lane_r[i]), int(seg[i]), int(lane_c[i])
        if t != cur_tile:
            cur_tile = t
            open_ids = []
        placed = False
        for cid in open_ids:
            used_r, cseg, wl = state[cid]
            if contig:
                w = sg - wl[0]
                if w < 0 or w >= max_windows:
                    continue
            else:
                w = wl.index(sg) if sg in wl else -1
                if w < 0 and len(wl) >= max_windows:
                    continue
            for s in range(nsub):
                have = cseg[s].get(lc)
                if have is not None and have != sg:
                    continue
                for rc in range(rot):
                    pl = (lr + stride * rc) & 127
                    if pl in used_r[s]:
                        continue
                    used_r[s].add(pl)
                    cseg[s][lc] = sg
                    if contig:
                        while len(wl) <= min(w, 7):
                            wl.append(wl[0] + len(wl))
                    elif w < 0:
                        wl.append(sg)
                        w = len(wl) - 1
                    e_chunk[i], e_sub[i], e_r2[i], e_rc[i] = cid, s, w, rc
                    placed = True
                    break
                if placed:
                    break
            if placed:
                break
        if not placed:
            cid = len(chunk_tile)
            chunk_tile.append(t)
            wl = [sg]
            used_r = [set() for _ in range(nsub)]
            cseg = [dict() for _ in range(nsub)]
            used_r[0].add(lr)
            cseg[0][lc] = sg
            state[cid] = (used_r, cseg, wl)
            wl_by_id[cid] = wl
            open_ids.append(cid)
            if len(open_ids) > ring:
                state.pop(open_ids.pop(0))
            e_chunk[i], e_sub[i], e_r2[i], e_rc[i] = cid, 0, 0, 0
    C0 = len(chunk_tile)
    windows = np.zeros((max(C0, 1), 8), np.int32)
    nwin = np.zeros(max(C0, 1), np.int32)
    for cid, wl in wl_by_id.items():
        windows[cid, : len(wl)] = wl
        nwin[cid] = len(wl)
    return (
        e_chunk, e_sub, e_r2, e_rc,
        np.asarray(chunk_tile, np.int64), windows[:C0], nwin[:C0],
    )


def assemble_plan(ec, e_sub, e_r2, e_rc, lane, q, val, rot,
                  vals_arr, packed):
    """One-pass plan assembly (csrc cfs_assemble_plan).

    Writes ``vals_arr`` (C, 8, 128) and the int16 ``packed`` field in
    place from the packer's sorted-domain outputs — the NumPy
    equivalent costs ~8 full passes in flat-index temporaries and
    fancy scatters. ``val`` must already be in the plan's value dtype.
    Returns True on success, False when native is unavailable (caller
    runs the NumPy scatters instead).
    """
    lib = _load()
    if lib is None:
        return False
    n = len(ec)
    val = np.ascontiguousarray(val)
    assert vals_arr.dtype == val.dtype and packed.dtype == np.int16
    lib.cfs_assemble_plan(
        np.ascontiguousarray(ec, np.int32),
        np.ascontiguousarray(e_sub, np.int32),
        np.ascontiguousarray(e_r2, np.int32),
        np.ascontiguousarray(e_rc, np.int32),
        np.ascontiguousarray(lane, np.int32),
        np.ascontiguousarray(q, np.int32),
        val.ctypes.data_as(ctypes.c_void_p), val.itemsize, n, rot,
        vals_arr.ctypes.data_as(ctypes.c_void_p),
        packed.reshape(-1),
    )
    return True


def assemble_sdia(g, j, joff, D, val, vals):
    """SDIA value fill (csrc cfs_assemble_sdia): val[i] lands at row
    g[i], diagonal plane j[i]+joff of the (R, D, 8, 128) layout. ``val``
    must already be in the plan's value dtype. Returns False when the
    native library is unavailable (caller scatters with NumPy)."""
    lib = _load()
    if lib is None:
        return False
    val = np.ascontiguousarray(val)
    assert vals.dtype == val.dtype
    lib.cfs_assemble_sdia(
        np.ascontiguousarray(g, np.int64),
        np.ascontiguousarray(j, np.int32),
        joff, len(g), D,
        val.ctypes.data_as(ctypes.c_void_p), val.itemsize,
        vals.ctypes.data_as(ctypes.c_void_p),
    )
    return True


def sym_off_counts(indptr, indices, n):
    """Per-offset strict-lower counts + structural diagonal count in one
    CSR pass (csrc cfs_sym_off_counts). Returns (cnt, ndiag) with cnt of
    length n (cnt[d] = entries on sub-diagonal d), or None when native
    is unavailable or a strict-upper entry exists."""
    lib = _load()
    if lib is None:
        return None
    cnt = np.zeros(n, np.int64)
    nd = np.zeros(1, np.int64)
    rc = lib.cfs_sym_off_counts(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, cnt, nd,
    )
    if rc < 0:
        return None
    return cnt, int(nd[0])


def sym_split_fill(indptr, indices, data, n, D, D0, dmap, mirror,
                   vals, diag, rrow, rcol, rval):
    """One-pass symmetric split + SDIA fill (csrc cfs_sym_split_fill):
    diagonal values to ``diag``, selected sub-diagonals into ``vals``
    (optionally mirrored into plane D0+j by column), the rest appended
    to the residual triples. ``data`` must be in the plan value dtype.
    Returns the residual count, or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data)
    assert diag.dtype == data.dtype and rval.dtype == data.dtype
    return int(lib.cfs_sym_split_fill(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        data.ctypes.data_as(ctypes.c_void_p), data.itemsize, n,
        D, D0, np.ascontiguousarray(dmap, np.int32), int(mirror),
        vals.ctypes.data_as(ctypes.c_void_p),
        diag.ctypes.data_as(ctypes.c_void_p),
        rrow, rcol, rval.ctypes.data_as(ctypes.c_void_p),
    ))


def dist_sym_count(indptr, indices, n, ndev, r_end, NB, shard_rows):
    """Pass A of the distributed symmetric shard split (csrc
    cfs_dist_sym_count): per-shard near-offset histograms + near/far/
    mirror counts + cross-device entry count, one CSR pass. Returns
    (off_cnt (ndev, shard_rows), cnt_near, cnt_far, cnt_mirror, cross)
    or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    off_cnt = np.zeros((ndev, shard_rows), np.int64)
    cnt_near = np.zeros(ndev, np.int64)
    cnt_far = np.zeros(ndev, np.int64)
    cnt_mirror = np.zeros(ndev, np.int64)
    cross = lib.cfs_dist_sym_count(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, ndev, np.ascontiguousarray(r_end, np.int64),
        NB, shard_rows, off_cnt.reshape(-1), cnt_near, cnt_far,
        cnt_mirror,
    )
    return off_cnt, cnt_near, cnt_far, cnt_mirror, int(cross)


def dist_sym_fill(indptr, indices, data, n, ndev, r_start, r_end, NB,
                  shard_rows, dmap, Dk, Du, mirror_planes, R_loc,
                  near_base, far_base, mir_base, near_r, near_c, near_v,
                  far_r, far_c, far_v, mir_r, mir_c, mir_v, dia_vals):
    """Pass B (csrc cfs_dist_sym_fill): route every strict-lower entry
    into the dense-diagonal planes / near residual / own-far / mirror
    streams in one CSR pass. ``data`` must be in the plan value dtype;
    triple arrays are preallocated from pass A's counts. Returns False
    when native is unavailable."""
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    lib.cfs_dist_sym_fill(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        data.ctypes.data_as(ctypes.c_void_p), data.itemsize,
        n, ndev,
        np.ascontiguousarray(r_start, np.int64),
        np.ascontiguousarray(r_end, np.int64),
        NB, shard_rows,
        np.ascontiguousarray(dmap, np.int32), len(dmap), Dk, Du,
        int(mirror_planes), R_loc,
        np.ascontiguousarray(near_base, np.int64),
        np.ascontiguousarray(far_base, np.int64),
        np.ascontiguousarray(mir_base, np.int64),
        near_r, near_c, near_v.ctypes.data_as(ctypes.c_void_p),
        far_r, far_c, far_v.ctypes.data_as(ctypes.c_void_p),
        mir_r, mir_c, mir_v.ctypes.data_as(ctypes.c_void_p),
        None if dia_vals is None
        else dia_vals.ctypes.data_as(ctypes.c_void_p),
    )
    return True


def sym_adjacency(indptr, indices, n, nnz_strict):
    """Symmetrized adjacency (indptr, indices) of a lower-triangle CSR
    in two native passes (csrc cfs_sym_adjacency); self-loops dropped.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    adj_indptr = np.zeros(n + 1, np.int64)
    adj_indices = np.empty(max(2 * nnz_strict, 1), np.int32)
    lib.cfs_sym_adjacency(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, adj_indptr, adj_indices,
    )
    return adj_indptr, adj_indices


def pair_mark(row, col, n, nb128, off_ok, threshold):
    """Full pairable marking in one native pass over the row-major
    residual stream (csrc cfs_pair_mark): same output block, per-offset
    predicate, AND per-(tile, offset) fragment count >= threshold.
    Returns (pairable bool array, count) or None when native is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    nr = len(row)
    pairable = np.zeros(max(nr, 1), np.uint8)
    scratch = np.zeros(n, np.int32)
    m = lib.cfs_pair_mark(
        np.ascontiguousarray(row, np.int32),
        np.ascontiguousarray(col, np.int32),
        nr, nb128,
        np.ascontiguousarray(off_ok, np.uint8), threshold,
        scratch, pairable,
    )
    return pairable[:nr].view(bool), int(m)
