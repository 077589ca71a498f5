"""Distributed SpMV over a mesh of devices that one process drives.

Port of ``cfs_spmv_tpu/parallel/dist.py``. Matrix rows are sharded
across the mesh in contiguous, block-aligned 128-row-tile ranges balanced
by nonzero count (``partition_by_nnz`` analog, ``tpp:437-541``); each
shard produces exactly its own y rows, so there is no cross-device
scatter or sum.

The host half is the reference's, decision for decision: the partition
(``bounds``, ``real``, ``shard_rows``), the geometry (``BT``, ``K``), the
resolved ``comm`` and ``halo_rows``, the union diagonals (``dia_offsets``,
``dia_mirror``), ``far_nnz`` and the ``assign="cluster"`` permutation, and
each shard's plans, which are the reference's per-shard plans before it
stacks them. The stacking itself is not ported: it gives every shard one
shape because ``shard_map`` needs one, whereas here each shard keeps its
own plans at its own size (``ShardPlan``, uploaded as ``ShardDevice``).

Per shard, as the reference's ``shard_fn``:

- symmetric matrices: the *near* part reads only the shard's own x
  segment — the paired stream (``sbell_spmv_tiles``), its residual
  (an accumulating stream, uploaded as its entry list and added by
  ``bell2_spmv_tiles_accum``, as the single-device applier does), the
  union diagonals (``sdia_sym_tiles``, or ``sdia_gen_tiles`` when
  mirrored) and ``diag * x``: ``ops/spmv.sbell_apply`` composes them;
- the *far* stream (all of a general matrix) needs remote x, by
  ``comm``: ``"gather"`` runs one ``bell2_spmv_tiles`` over the whole x,
  ``"halo"`` one over the window ``[r0 - H, r0 + S + H)`` that the two
  neighbours' H boundary rows complete, and ``"ring"`` P accumulating
  steps (``bell2_spmv_tiles_accum``), step k on the segment of shard
  ``(d + k) % P``; every ring stream is compacted to its entry list at
  upload, and an empty one launches nothing.

``matmat`` and a 2-D X run the same branches through the multi-RHS
kernels. Every mesh (``parallel/mesh.py``) exchanges x in one form:
buffers that the operator owns on each shard's device (``_Buffers``),
made at the first apply of a key of x's trailing shape and type and
filled by copies from the global x on the mesh's first device: each
shard's segment or halo window (``[H | segment | H]``, filled straight
from x, so no halo waits for a neighbour's kernels), the whole x
(``"gather"``, on a device other than x's) or the other shards' segments
(``"ring"``), and each shard's y. Every fill is issued before any shard's
kernels (``_across``). The meshes differ in where the buffers lie and
where y goes:

- one process, one device (several shards on one card, the counterpart
  of the reference's virtual devices): every shard's buffers on that
  device; each shard's rows of y are copied into one output;
- one process, several devices: each shard's buffers on its device, and
  its rows of y copied back into one output on the first;
- one process a shard (a process-group mesh, ``parallel/multihost.py``):
  every rank makes the same host decisions and plans (the reference's
  "identical plan on every host"), uploads only its own shard
  (``shards[d]`` is None for the others) and holds buffers for it alone,
  filled from the global x that every rank is given on its own device.
  The one collective is y's: an all-gather of every shard's real rows, so
  every rank returns the whole y, as the single-process operator does.
  (Exchanging x segments by collectives would only move rows every rank
  already holds; an x that is not global on every rank is not ported.)

On a mesh of one card (and on a process-group mesh of one card a rank) an
apply never waits for the card, so ``utils/timing.time_matvec`` and the
solvers capture it in a CUDA graph, the all-gather included; their eager
warm-up makes the buffers before the capture. Across several cards of one
process the operator captures its own apply at B = 1, once, at the end of
the construction (``_capture``): one CUDA graph over every card, the
copies and each shard's kernels on a stream of their card, over the
buffers of that key and an input x and gathered y on the first card; the
shard appliers' temporaries live in the graph's pool on the first card
and in a pool of the operator's on every other card
(``torch.cuda.MemPool``), so a replay touches no memory that other code
may have taken since. Every B = 1 apply there copies x into the graph's
input, replays, and returns a copy of its y. The multi-RHS apply, the
plain twins (``plain=True``) and a mesh of CPU devices run the same
schedule eagerly over the same buffers. A solver cannot nest that graph
in its own: :attr:`DistSpDMV.capturable` is False there, and the solvers
run their loop eagerly, one replay an apply, with no host sync in it
(``models/solvers._Operator``).

The steps are the port's spans (``utils/trace``): an apply is
``cfs.dist.apply`` (``rhs``, ``comm``, ``cards``) over
``cfs.dist.scatter`` (one ``cfs.dist.exchange``, ``comm``, a shard), one
``cfs.dist.shard`` a shard (``shard``, ``device``) and
``cfs.dist.gather``; a replayed apply is ``cfs.dist.apply`` over one
``cfs.dist.replay``. The construction is ``cfs.dist.build`` over
``cfs.dist.plan`` (the partition, the split and every shard's plans),
``cfs.dist.upload`` (while recording, it ends once each card's copies
have) and, across several cards, ``cfs.dist.capture`` (the warm-up apply
and the capture). The counter ``dist.copy_bytes`` adds the bytes each
copy between two of the mesh's cards moves (scatter, exchanges, gather),
a replay those of its schedule, reckoned at the capture;
``dist.graph_captures`` and ``dist.graph_replays`` count the captures and
the replayed applies.

float64 (``dtype=np.float64``, as the reference's; its tests run it with
x64 on): the plans are built in float64, uploaded as they are, and
applied through the float32 appliers of ``ops/spmv.py``, which take
float64 operands: the paired stream (B5/B10) and the mirrored diagonals
(B6/B12) run the double instances of their kernels, the union diagonals
the double symmetric kernel (B13/B14), the far grids the double grid
kernel (B15/B16), and the paired residual and every ring stream its
double entry kernel. No shard plan is degree-grouped (every one is built
with ``allow_relax=False``, which never tries the grouping), so the
unpermute (B3/B9), whose wrappers take float32 only, is never reached.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import native as _native
from ..formats.bell2 import (
    LANES,
    Bell2Plan,
    build_bell2_from_arrays,
    build_bell2_plan,
)
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.sbell import SBellPlan, build_sbell_plan
from ..formats.sdia import (
    BLOCK_ROWS,
    SDIA_FILL,
    SDIA_MAX_D,
    SDIA_MIN_COUNT,
)
from ..ops import spmv as spmv_ops
from ..ops.sdia_kernel import _blocks_per_step, gen_window, stages_x
from ..tuning.partition import (
    estimate_imbalance,
    partition_tiles_by_nnz,
    tile_nnz_histogram,
)
from ..utils import trace
from ..utils.logging import info, warn
from .mesh import ROWS_AXIS

__all__ = ["DistSpDMV", "ShardPlan", "ShardDevice", "shard_csr_rows"]


def _slice_csr_rows(csr: CSR, r0: int, r1: int, pad_rows: int) -> CSR:
    """Rows [r0, r1) as a local CSR padded to ``pad_rows`` rows."""
    p0, p1 = csr.indptr[r0], csr.indptr[r1]
    indptr = (csr.indptr[r0 : r1 + 1] - p0).astype(np.int64)
    indptr = np.pad(indptr, (0, pad_rows - (r1 - r0)), mode="edge")
    return CSR(pad_rows, csr.ncols, indptr, csr.indices[p0:p1],
               csr.data[p0:p1], csr.symmetric)


def shard_csr_rows(csr: CSR, ndev: int, align_tiles: int = 1):
    """Equal-nnz contiguous row-tile shard bounds (ref ``tpp:437-541``),
    aligned to ``align_tiles`` tiles."""
    T = max(1, -(-csr.nrows // LANES))
    hist = tile_nnz_histogram(csr.indptr, T)
    bounds = partition_tiles_by_nnz(hist, ndev)
    if align_tiles > 1:
        bounds = (np.round(bounds / align_tiles) * align_tiles).astype(
            np.int64
        )
        np.maximum.accumulate(bounds, out=bounds)
        bounds = np.minimum(bounds, T)
        bounds[0], bounds[-1] = 0, T
    work = [
        int(hist[bounds[d] : bounds[d + 1]].sum()) for d in range(ndev)
    ]
    info(
        "shard: %d devices, nnz/dev %s, imbalance %.3f",
        ndev, work, estimate_imbalance(np.maximum(work, 1)),
    )
    return bounds


@dataclasses.dataclass
class ShardPlan:
    """One shard's host plans, in its local coordinates: what the
    reference stacks into its (D, ...) arrays, before the stacking."""

    #: symmetric matrices: the paired plan of the near residual (built
    #: with ``dia=False``; its ``far`` is the paired residual)
    paired: SBellPlan | None = None
    #: symmetric: the union diagonals' (R_loc, Dk, 8, 128) values
    dia: np.ndarray | None = None
    #: symmetric: the main diagonal, (shard_rows,)
    diag: np.ndarray | None = None
    #: comm "gather"/"halo": the far stream (a general matrix's whole
    #: shard), over the whole x or the halo window
    far: Bell2Plan | None = None
    #: comm "ring": step k's accumulating stream, the entries whose
    #: columns live on shard (d + k) % P, in that shard's coordinates
    ring: list[Bell2Plan] | None = None


@dataclasses.dataclass
class ShardDevice:
    """One shard's streams on its device (``ops/spmv`` structs)."""

    #: symmetric: paired stream, paired residual, union diagonals, diag
    near: spmv_ops.SBellDevice | None
    far: spmv_ops.Bell2Device | None
    ring: list[spmv_ops.Bell2Device] | None


@dataclasses.dataclass
class _Buffers:
    """What an apply writes, on each shard's device, allocated once for a
    key of x's trailing shape and type; every row that no fill writes
    stays zero. On a process-group mesh only this rank's shard has them
    (None, and no fills, for the others)."""

    #: shard d's x: its halo window ``[H | segment | H]`` (comm "halo"),
    #: else its segment (S rows)
    xs: list
    #: comm "gather": the whole x on shard d's device (None where x itself
    #: is read: on the first device, or where the far stream is empty)
    full: list
    #: comm "ring": step k's segment, of shard (d + k) % P, on shard d's
    #: device (k = 0: ``xs[d]``; None where the step's stream is empty)
    ring: list
    #: shard d's y, where its parts are summed or zeroed
    ys: list
    #: shard d's fills: (destination, a, b), x's rows [a, b) into the
    #: destination (a view of one of the buffers above)
    fills: list
    #: the bytes an apply copies between two different cards
    moved: int
    #: the captured key's input x and gathered y, on the first device
    x: torch.Tensor | None = None
    y: torch.Tensor | None = None


@dataclasses.dataclass
class _Graph:
    """The captured B = 1 apply: the graph, its buffers, and the memory
    pools of the cards other than the first (the graph's own pool holds
    the first card's temporaries)."""

    graph: torch.cuda.CUDAGraph
    bufs: _Buffers
    pools: list


class DistSpDMV:
    """Mesh-parallel SpDMV functor (the multi-device ``SpDMV`` analog).

    Construction = preprocessing (partition + per-shard planning + upload
    to each shard's device), call = y = A @ x with the global x and the
    global y on the mesh's first device (on a process-group mesh: on every
    rank, on its own device), as the reference's functor
    (``sparse_kernel.hpp:17-27``). ``dtype`` (float32 or float64) is the
    ``torch.dtype`` of x and y, and ``device`` the device they live on, as
    a ``TunedMatrix`` has them, so ``utils/timing`` and the solvers take a
    ``DistSpDMV`` as they take a tuned matrix.
    """

    def __init__(self, A, mesh, *, dtype=np.float32, dia_min_count=None,
                 comm: str = "auto", assign: str = "contiguous"):
        from ..matrix import SparseMatrix

        csr = A.csr if isinstance(A, SparseMatrix) else A
        self.dia_min_count = (
            SDIA_MIN_COUNT if dia_min_count is None else dia_min_count
        )
        if comm not in ("auto", "gather", "ring", "halo"):
            raise ValueError(
                "comm must be 'auto', 'gather', 'ring' or 'halo', "
                f"got {comm}"
            )
        if assign not in ("contiguous", "cluster"):
            raise ValueError(
                f"assign must be 'contiguous' or 'cluster', got {assign}"
            )
        if csr.ncols != csr.nrows:
            # x is distributed by the ROW partition; a rectangular x has
            # no owner for columns beyond nrows
            raise NotImplementedError(
                "DistSpDMV requires a square matrix (row-partitioned x); "
                f"got {csr.nrows}x{csr.ncols}"
            )
        if np.dtype(dtype) not in (np.float32, np.float64):
            raise TypeError(
                f"DistSpDMV runs float32 or float64, got {np.dtype(dtype)}")
        #: halo strategy for the far stream, as the reference's:
        #: "halo" (the 2*H boundary rows of the neighbours), "gather"
        #: (the whole x), "ring" (ndev segment rotations, each consumed by
        #: its far sub-stream), "auto" (halo when ndev > 1 and H fits one
        #: neighbour segment, else gather)
        self.comm = comm
        self.halo_rows = 0
        self.mesh = mesh
        self.ndev = mesh.shape[ROWS_AXIS]
        self.nrows = csr.nrows
        self.ncols = csr.ncols
        self.symmetric = csr.symmetric
        self._np_dtype = np.dtype(dtype)
        self.dtype = (torch.float64 if self._np_dtype == np.float64
                      else torch.float32)
        self.device = mesh.row_devices[0]
        #: this process's shard on a process-group mesh (y is all-gathered);
        #: None where one process drives every shard
        self.rank = mesh.rank if mesh.group is not None else None
        #: the buffers of an apply (``_Buffers``), by key
        self._bufs: dict = {}
        #: the captured B = 1 apply (``_Graph``), across several cards
        self._graph = None
        with trace.span("cfs.dist.build", nrows=csr.nrows, shards=self.ndev):
            with trace.span("cfs.dist.plan"):
                self._plan(csr, assign)
            with trace.span("cfs.dist.upload"):
                self._place()
                if trace.is_recording():
                    for dev in set(self.mesh.row_devices):
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
            if not self.capturable and all(
                    dev.type == "cuda" for dev in self.mesh.row_devices):
                with trace.span("cfs.dist.capture"):
                    self._capture()

    def _plan(self, csr: CSR, assign: str) -> None:
        """The host half: the assignment, the geometry, the partition and
        every shard's plans."""
        #: locality-aware assignment (METIS analog, tuning/cluster.py):
        #: greedy tile clustering permutes rows so that the contiguous
        #: equal-nnz shards cut fewer edges — shrinking the far stream,
        #: the only stream that communicates
        self.perm = None
        self._iperm = None
        if assign == "cluster" and csr.nnz:
            from ..tuning.cluster import choose_cluster_assignment

            res = choose_cluster_assignment(csr, self.ndev)
            if res is not None:
                self.perm, csr = res
                self._iperm = np.empty_like(self.perm)
                self._iperm[self.perm] = np.arange(len(self.perm))

        T = max(1, -(-csr.nrows // LANES))
        # output-block size adapts down for tiny (test) matrices
        tiles_per_dev = max(1, T // max(self.ndev, 1))
        self.BT = 8
        while self.BT * 2 <= min(128, tiles_per_dev):
            self.BT *= 2
        self.K = 16 if T < 64 else 128

        if csr.symmetric:
            self._init_symmetric(csr)
        else:
            self._init_general(csr)

    # ------------------------------------------------------------------
    def _build_ring_far(self, entries):
        """Ring-mode far streams: ``entries[d] = (local_row, global_col,
        val)``. Returns, for each shard d, one accumulating BELL2 stream
        per ring step k, holding shard d's entries whose columns live on
        device (d + k) % ndev, in that device's local coordinates — so
        step k of the rotation applies them against that segment."""
        self.K_ring = min(self.K, 32)
        per_d = [[None] * self.ndev for _ in range(self.ndev)]
        starts = np.array([self.real[e][0] for e in range(self.ndev)],
                          dtype=np.int64)
        ends = starts + np.array(
            [self.real[e][1] for e in range(self.ndev)], dtype=np.int64
        )
        for d in range(self.ndev):
            lr, gc, v = entries[d]
            # one-pass bucketing by column-owner device: a stable sort by
            # owner keeps the entry order within each bucket
            owner = np.searchsorted(ends, gc, side="right")
            order = np.argsort(owner, kind="stable")
            so = owner[order]
            cuts = np.searchsorted(so, np.arange(self.ndev + 1))
            lro, gco, vo = lr[order], gc[order], v[order]
            for k in range(self.ndev):
                e = (d + k) % self.ndev
                lo, hi = cuts[e], cuts[e + 1]
                c0 = starts[e]
                # raw triples straight into the slot packer
                per_d[d][k] = build_bell2_from_arrays(
                    self.shard_rows, self.shard_rows,
                    lro[lo:hi].astype(np.int32),
                    (gco[lo:hi] - c0).astype(np.int32),
                    np.asarray(vo[lo:hi], self._np_dtype),
                    dtype=self._np_dtype,
                    chunks_per_step=self.K_ring, tiles_per_block=self.BT,
                    cover_all_tiles=False,
                    allow_runs=False, allow_relax=False, force_slot=True,
                )
        return per_d

    # ------------------------------------------------------------------
    def _halo_pregate(self, row, col, T, bt_align=1):
        """Uniform row partition for halo comm, or None.

        The halo exchange's neighbour slices require globally contiguous
        segments: every shard except the last holds exactly
        ``shard_rows`` real rows, so halo mode switches the partitioner
        from equal-nnz to UNIFORM tiles. Viability is pre-gated on the
        matrix bandwidth: the window overhang H never exceeds
        max|col - row|, so bw <= one uniform segment guarantees the
        exact H computed later fits too."""
        if self.comm not in ("auto", "halo") or self.ndev <= 1:
            return None
        if not len(row):
            return None
        bw = int(
            np.max(np.abs(col.astype(np.int64) - row.astype(np.int64)))
        )
        Tu = -(-T // self.ndev)
        Tu = -(-Tu // bt_align) * bt_align
        if -(-bw // LANES) * LANES > Tu * LANES:
            return None
        self._halo_ok = True
        return np.minimum(
            np.arange(self.ndev + 1, dtype=np.int64) * Tu, T
        )

    # ------------------------------------------------------------------
    def _resolve_comm(self, H_need: int) -> None:
        """Pick the halo strategy once the far column overhang is known
        (``H_need`` = max rows any shard's far/x window extends past its
        own segment, both directions)."""
        if self.comm == "ring":
            return
        H = max(0, -(-int(H_need) // LANES) * LANES)
        fits = (
            self.ndev > 1
            and H <= self.shard_rows
            and getattr(self, "_halo_ok", False)
        )
        if self.comm == "halo" and not fits:
            warn(
                "dist: halo comm requested but the far window (%d rows)"
                " exceeds one neighbor segment (%d) or ndev == 1 — "
                "falling back to gather", H, self.shard_rows,
            )
            self.comm = "gather"
            return
        if self.comm == "auto":
            self.comm = "halo" if fits else "gather"
        if self.comm == "halo":
            self.halo_rows = H
            info(
                "dist: halo comm (H=%d rows = %.1f KB/device vs "
                "%.1f KB full-x)", H, 2 * H * 4 / 1024,
                (self.ndev - 1) * self.shard_rows * 4 / 1024,
            )

    # ------------------------------------------------------------------
    def _init_general(self, csr: CSR):
        T = max(1, -(-csr.nrows // LANES))
        bounds = None
        if self.comm in ("auto", "halo") and self.ndev > 1:
            row0 = np.repeat(
                np.arange(csr.nrows, dtype=np.int64), np.diff(csr.indptr)
            )
            bounds = self._halo_pregate(row0, csr.indices, T)
            del row0
        if bounds is None:
            bounds = shard_csr_rows(csr, self.ndev, align_tiles=1)
        T_max = max(1, max(int(bounds[d + 1] - bounds[d])
                           for d in range(self.ndev)))
        self.shard_rows = T_max * LANES
        self.nnz_full = csr.nnz
        self.bounds = bounds
        self.real = [
            (min(int(bounds[d]) * LANES, csr.nrows),
             min(int(bounds[d + 1]) * LANES, csr.nrows)
             - min(int(bounds[d]) * LANES, csr.nrows))
            for d in range(self.ndev)
        ]
        ends = np.array([self.real[d][0] + self.real[d][1]
                         for d in range(self.ndev)], dtype=np.int64)
        row_all = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                            np.diff(csr.indptr))
        own = np.searchsorted(ends, row_all, side="right")
        colo = np.searchsorted(ends, csr.indices.astype(np.int64),
                               side="right")
        #: nonzeros whose x column lives on another device — the only
        #: traffic that rides the interconnect (halo volume diagnostic)
        self.far_nnz = int(np.count_nonzero(own != colo))
        if self.comm == "ring":
            entries = []
            for d in range(self.ndev):
                r0, nr = self.real[d]
                shard = _slice_csr_rows(csr, r0, r0 + nr, self.shard_rows)
                lr = np.repeat(
                    np.arange(self.shard_rows, dtype=np.int64),
                    np.diff(shard.indptr),
                )
                entries.append(
                    (lr, shard.indices.astype(np.int64), shard.data)
                )
            self.plans = [ShardPlan(ring=r)
                          for r in self._build_ring_far(entries)]
            return
        shards = []
        H_need = 0
        for d in range(self.ndev):
            r0, nr = self.real[d]
            shard = _slice_csr_rows(csr, r0, r0 + nr, self.shard_rows)
            shard.symmetric = False
            if len(shard.indices):
                c = shard.indices
                H_need = max(
                    H_need,
                    int(r0 - c.min()),
                    int(c.max()) + 1 - (r0 + self.shard_rows),
                )
            shards.append((r0, shard))
        self._resolve_comm(H_need)
        self.plans = []
        for r0, shard in shards:
            if self.comm == "halo":
                H = self.halo_rows
                shard = CSR(
                    shard.nrows, self.shard_rows + 2 * H,
                    shard.indptr,
                    shard.indices - np.int64(r0 - H),
                    shard.data, False,
                )
            self.plans.append(ShardPlan(far=build_bell2_plan(
                shard, dtype=self._np_dtype,
                chunks_per_step=self.K, tiles_per_block=self.BT,
                allow_runs=False, allow_relax=False,
                # slot packer directly: the unit pipeline is ~40x slower
                # on dense far/stencil diagonals
                force_slot=True,
            )))

    # ------------------------------------------------------------------
    def _select_union_dia(self, union):
        """Shared dense-diagonal selection for the shard split paths:
        sets dia_offsets/_dia_pos/dia_mirror from the per-shard union
        counts and returns (Du, Dk, R_loc, dmap_arr)."""
        # over-full union: keep the heaviest-count offsets (mirrors
        # extract_sdia's heaviest-first truncation)
        keep = sorted(union, key=lambda o: (-union[o], o))[:SDIA_MAX_D]
        self.dia_offsets = tuple(sorted(keep))
        # the reference's whole-y SDIA kernel keeps a shard's y (+x) in
        # TPU VMEM; shards past this many rows store MIRRORED (+d, -d)
        # planes for the segmented kernel instead (sdia_gen_tiles). The
        # ceiling is the TPU's; the port keeps it so that both packages
        # make the same plan. Env CFS_DIST_SDIA_ROWS_MAX overrides.
        rows_max = int(
            os.environ.get("CFS_DIST_SDIA_ROWS_MAX", 5_000_000)
        )
        self.dia_mirror = bool(
            self.dia_offsets and self.shard_rows > rows_max
        )
        self._dia_pos = self.dia_offsets
        if self.dia_mirror:
            info(
                "dist: shard_rows=%d exceeds the whole-y SDIA gate "
                "(%d): mirrored segmented SDIA", self.shard_rows,
                rows_max,
            )
            self.dia_offsets = self._dia_pos + tuple(
                -o for o in self._dia_pos
            )
        Du = len(self._dia_pos)
        Dk = len(self.dia_offsets)  # kernel planes (2*Du when mirrored)
        R_loc = -(-self.shard_rows // BLOCK_ROWS)
        if Dk:
            RB = _blocks_per_step(R_loc, Dk)
            R_loc = -(-R_loc // RB) * RB
        dmap_arr = np.full(self.shard_rows, -1, np.int32)
        for jj, o in enumerate(self._dia_pos):
            dmap_arr[o] = jj
        return Du, Dk, R_loc, dmap_arr

    # ------------------------------------------------------------------
    def _shard_paired_plan(self, nr_, nc_, nv_):
        """Paired SBELL plan for one shard's near residual (local
        coordinates); the union diagonals are the caller's, hence
        dia=False, and allow_relax=False as in the reference."""
        ncoo = COO(
            self.shard_rows, self.shard_rows,
            np.ascontiguousarray(nr_, np.int32),
            np.ascontiguousarray(nc_, np.int32),
            np.ascontiguousarray(nv_, self._np_dtype),
            symmetric=True,
        )
        return build_sbell_plan(
            CSR.from_coo(ncoo), dtype=self._np_dtype,
            chunks_per_step=self.K, tiles_per_block=self.BT,
            transpose_windows=2, dia=False, allow_relax=False,
        )

    # ------------------------------------------------------------------
    def _native_sym_split(self, lower, r_starts, r_ends):
        """Native two-pass shard split (csrc cfs_dist_sym_count/_fill).

        Returns (paired_plans, far_raw, dia_big, H_need) or None when
        the native library is unavailable (the caller then runs
        ``_numpy_sym_split``, which produces the same outputs)."""
        n = lower.nrows
        if n >= 2**31:
            # cfs_dist_sym_fill stores global rows and columns as int32
            # (csrc/cfs_native.cpp:803)
            raise NotImplementedError(
                f"the native shard split takes fewer than 2**31 rows, got {n}"
            )
        NB = self.BT * LANES
        nat = _native.dist_sym_count(
            lower.indptr, lower.indices, n, self.ndev, r_ends, NB,
            self.shard_rows,
        )
        if nat is None:
            return None
        off_cnt, cnt_near, cnt_far, cnt_mirror, cross = nat
        self.far_nnz = 2 * cross

        # union of qualifying dense diagonals, per-shard thresholds
        # identical to the NumPy path
        union: dict[int, int] = {}
        for d in range(self.ndev):
            cf = off_cnt[d]
            uniq = np.flatnonzero(cf)
            cnt = cf[uniq]
            length = np.maximum(self.shard_rows - uniq, 1)
            ok = (uniq > 0) & (cnt >= self.dia_min_count) & (
                cnt >= SDIA_FILL * length
            )
            for o, c in zip(uniq[ok], cnt[ok]):
                union[int(o)] = union.get(int(o), 0) + int(c)
        Du, Dk, R_loc, dmap_arr = self._select_union_dia(union)

        if Du:
            sel = np.array(self._dia_pos, np.int64)
            absorbed = off_cnt[:, sel].sum(axis=1)
        else:
            absorbed = np.zeros(self.ndev, np.int64)
        n_near = cnt_near - absorbed
        near_base = np.concatenate([[0], np.cumsum(n_near)])
        far_base = np.concatenate([[0], np.cumsum(cnt_far)])
        mir_base = np.concatenate([[0], np.cumsum(cnt_mirror)])
        tot_n, tot_f, tot_m = (
            int(near_base[-1]), int(far_base[-1]), int(mir_base[-1])
        )
        near_r = np.empty(max(tot_n, 1), np.int32)
        near_c = np.empty(max(tot_n, 1), np.int32)
        near_v = np.empty(max(tot_n, 1), self._np_dtype)
        far_r = np.empty(max(tot_f, 1), np.int32)
        far_c = np.empty(max(tot_f, 1), np.int32)
        far_v = np.empty(max(tot_f, 1), self._np_dtype)
        mir_r = np.empty(max(tot_m, 1), np.int32)
        mir_c = np.empty(max(tot_m, 1), np.int32)
        mir_v = np.empty(max(tot_m, 1), self._np_dtype)
        dia_big = (
            np.zeros((self.ndev, R_loc, Dk, 8, LANES), self._np_dtype)
            if Du else None
        )
        data_c = np.ascontiguousarray(np.asarray(lower.data, self._np_dtype))
        if not _native.dist_sym_fill(
            lower.indptr, lower.indices, data_c, n, self.ndev,
            r_starts, r_ends, NB, self.shard_rows, dmap_arr, Dk, Du,
            self.dia_mirror, R_loc,
            near_base[:-1], far_base[:-1], mir_base[:-1],
            near_r, near_c, near_v, far_r, far_c, far_v,
            mir_r, mir_c, mir_v, dia_big,
        ):
            return None

        paired_plans, far_raw = [], []
        H_need = 0
        for d in range(self.ndev):
            r0, _ = self.real[d]
            sn = slice(near_base[d], near_base[d + 1])
            paired_plans.append(
                self._shard_paired_plan(near_r[sn], near_c[sn],
                                        near_v[sn])
            )
            sf = slice(far_base[d], far_base[d + 1])
            sm = slice(mir_base[d], mir_base[d + 1])
            lr = np.concatenate([far_r[sf], mir_r[sm]]).astype(np.int64)
            mc = np.concatenate([far_c[sf], mir_c[sm]]).astype(np.int64)
            mv = np.concatenate([far_v[sf], mir_v[sm]])
            far_raw.append((r0, lr, mc, mv))
            if len(mc):
                H_need = max(
                    H_need,
                    int(r0 - mc.min()),
                    int(mc.max()) + 1 - (r0 + self.shard_rows),
                )
        dias = list(dia_big) if dia_big is not None else [None] * self.ndev
        return paired_plans, far_raw, dias, H_need

    # ------------------------------------------------------------------
    def _numpy_sym_split(self, lower, r_starts, r_ends):
        """NumPy shard split (fallback when the native library is
        absent; the same outputs as ``_native_sym_split``)."""
        BT = self.BT
        row = np.repeat(
            np.arange(lower.nrows, dtype=np.int64), np.diff(lower.indptr)
        )
        col = lower.indices.astype(np.int64)
        val = np.asarray(lower.data)
        tile = row >> 7
        seg = col >> 7
        near = (tile // BT) == (seg // BT)

        # the row stream is CSR-sorted: each shard's rows are a
        # searchsorted slice; the mirror image is bucketed once by
        # column owner with a stable argsort
        row_lo = np.searchsorted(row, r_starts)
        row_hi = np.searchsorted(row, r_ends)

        # --- per-shard near entries in local coordinates --------------
        shard_near = []
        for d in range(self.ndev):
            r0 = r_starts[d]
            sl = slice(row_lo[d], row_hi[d])
            ns = near[sl]
            shard_near.append(
                ((row[sl][ns] - r0), (col[sl][ns] - r0), val[sl][ns])
            )

        # --- union of qualifying dense diagonals ----------------------
        union: dict[int, int] = {}  # offset -> total count across shards
        for nr_, nc_, _ in shard_near:
            if not len(nr_):
                continue
            offd = nr_ - nc_
            cnt_full = np.bincount(offd, minlength=self.shard_rows)
            uniq = np.flatnonzero(cnt_full)
            cnt = cnt_full[uniq]
            length = np.maximum(self.shard_rows - uniq, 1)
            ok = (uniq > 0) & (cnt >= self.dia_min_count) & (
                cnt >= SDIA_FILL * length
            )
            for o, c in zip(uniq[ok], cnt[ok]):
                union[int(o)] = union.get(int(o), 0) + int(c)
        Du, Dk, R_loc, dmap_arr = self._select_union_dia(union)

        # halo diagnostic: entries (either image) whose x column lives
        # on another device
        ro = np.searchsorted(r_ends, row, side="right")
        co = np.searchsorted(r_ends, col, side="right")
        self.far_nnz = 2 * int(np.count_nonzero(ro != co))

        # mirror image (col, row, val) of far entries, bucketed once by
        # column owner (stable: per-shard order as the masked gathers)
        mi = np.flatnonzero(~near)
        morder = mi[np.argsort(co[mi], kind="stable")]
        mcuts = np.concatenate(
            [[0], np.cumsum(np.bincount(co[mi], minlength=self.ndev))]
        ).astype(np.int64)

        paired_plans, far_raw, dias = [], [], []
        H_need = 0
        for d in range(self.ndev):
            r0, nr = self.real[d]
            nr_, nc_, nv_ = shard_near[d]
            dv = None
            if Du:
                j_all = dmap_arr[nr_ - nc_]
                on_dia = j_all >= 0
                dv = np.zeros((R_loc, Dk, 8, LANES), self._np_dtype)
                g = nr_[on_dia].astype(np.int64)
                j = j_all[on_dia]
                v_dia = np.ascontiguousarray(nv_[on_dia], self._np_dtype)
                if not _native.assemble_sdia(g, j, 0, Dk, v_dia, dv):
                    dv[g // BLOCK_ROWS, j,
                       (g // LANES) % 8, g % LANES] = v_dia
                if self.dia_mirror:
                    # the -d plane: same values scattered by COLUMN
                    gc = nc_[on_dia].astype(np.int64)
                    if not _native.assemble_sdia(
                        gc, j, Du, Dk, v_dia, dv
                    ):
                        dv[gc // BLOCK_ROWS, Du + j,
                           (gc // LANES) % 8, gc % LANES] = v_dia
                nr_, nc_, nv_ = nr_[~on_dia], nc_[~on_dia], nv_[~on_dia]
            dias.append(dv)
            sl = slice(row_lo[d], row_hi[d])
            fr_d = row[sl][~near[sl]]
            fc_d = col[sl][~near[sl]]
            fv_d = val[sl][~near[sl]]
            md = morder[mcuts[d]:mcuts[d + 1]]
            paired_plans.append(self._shard_paired_plan(nr_, nc_, nv_))
            # far: local rows, global cols, one-sided — this shard owns
            # rows of both mirror images that fall in [r0, r1)
            mr = np.concatenate([fr_d, col[md]])
            mc = np.concatenate([fc_d, row[md]])
            mv = np.concatenate([fv_d, val[md]])
            far_raw.append((r0, (mr - r0).astype(np.int64),
                            mc.astype(np.int64), mv))
            if len(mc):
                H_need = max(
                    H_need,
                    int(r0 - mc.min()),
                    int(mc.max()) + 1 - (r0 + self.shard_rows),
                )
        return paired_plans, far_raw, dias, H_need

    def _init_symmetric(self, csr: CSR):
        lower, diag, _ = csr.split_triangle()
        rowlen = np.diff(lower.indptr)
        row = np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen)
        self.nnz_full = 2 * len(row) + int(np.count_nonzero(diag))

        # balance on total work per tile (both triangles); halo comm
        # (viable for banded structure) switches to uniform tiles
        T = max(1, -(-csr.nrows // LANES))
        BT = self.BT
        bounds = self._halo_pregate(row, lower.indices, T, bt_align=BT)
        del row
        if bounds is None:
            hist = tile_nnz_histogram(lower.indptr, T)
            histT = np.zeros(T, np.int64)
            np.add.at(histT, lower.indices >> 7, 1)
            bounds = partition_tiles_by_nnz(hist + histT, self.ndev)
            bounds = (np.round(bounds / BT) * BT).astype(np.int64)
            np.maximum.accumulate(bounds, out=bounds)
            bounds = np.minimum(bounds, -(-csr.nrows // LANES))
            bounds[0] = 0
            bounds[-1] = -(-csr.nrows // LANES)
        self.bounds = bounds

        T_max = max(1, max(int(bounds[d + 1] - bounds[d])
                           for d in range(self.ndev)))
        self.shard_rows = T_max * LANES
        self.real = [
            (min(int(bounds[d]) * LANES, csr.nrows),
             min(int(bounds[d + 1]) * LANES, csr.nrows)
             - min(int(bounds[d]) * LANES, csr.nrows))
            for d in range(self.ndev)
        ]

        r_starts = np.array(
            [self.real[d][0] for d in range(self.ndev)], np.int64
        )
        r_ends = r_starts + np.array(
            [self.real[d][1] for d in range(self.ndev)], np.int64
        )
        res = self._native_sym_split(lower, r_starts, r_ends)
        if res is None:
            res = self._numpy_sym_split(lower, r_starts, r_ends)
        paired_plans, far_raw, dias, H_need = res
        del lower
        diags = []
        for d in range(self.ndev):
            r0, nr = self.real[d]
            dg = np.zeros(self.shard_rows, self._np_dtype)
            dg[:nr] = diag[r0:r0 + nr]
            diags.append(dg)

        self._resolve_comm(H_need)
        far_plans = []
        for r0, lr, gc, mv in far_raw:
            if self.comm == "ring":
                far_plans.append((lr, gc, mv))
                continue
            if self.comm == "halo":
                H = self.halo_rows
                gc = gc - (r0 - H)
                ncols_w = self.shard_rows + 2 * H
            else:
                ncols_w = csr.ncols
            # raw triples straight into the slot packer (entries are
            # unique by construction)
            far_plans.append(
                build_bell2_from_arrays(
                    self.shard_rows, ncols_w,
                    lr.astype(np.int32), gc.astype(np.int32),
                    np.asarray(mv, self._np_dtype), dtype=self._np_dtype,
                    chunks_per_step=self.K, tiles_per_block=self.BT,
                    allow_runs=False, allow_relax=False, force_slot=True,
                )
            )
        if self.comm == "ring":
            ring = self._build_ring_far(far_plans)
            far_plans = [None] * self.ndev
        else:
            ring = [None] * self.ndev
        self.plans = [
            ShardPlan(paired=p, dia=dv, diag=dg, far=f, ring=r)
            for p, dv, dg, f, r in zip(paired_plans, dias, diags,
                                       far_plans, ring)
        ]

    # ------------------------------------------------------------------
    def _place(self):
        """Upload each shard's plans to its device, at the shard's own
        size; the accumulating streams (the paired residual, every ring
        stream) as their entry lists. On a process-group mesh only this
        rank's shard; the others' entries stay None."""
        offsets = getattr(self, "dia_offsets", ())
        self.shards = []
        for d, (dev, plan) in enumerate(zip(self.mesh.row_devices,
                                            self.plans)):
            if self.rank is not None and d != self.rank:
                self.shards.append(None)
                continue
            near = None
            if plan.paired is not None:
                near = dataclasses.replace(
                    spmv_ops.sym_to_device(plan.paired, dev),
                    diag=torch.from_numpy(plan.diag).to(dev),
                )
                if plan.dia is not None:
                    near = dataclasses.replace(
                        near,
                        dia_vals=torch.from_numpy(plan.dia).to(dev),
                        dia_offsets=torch.tensor(offsets, dtype=torch.int32,
                                                 device=dev),
                        dia_mirrored=self.dia_mirror,
                        dia_stage_x=stages_x(offsets),
                        dia_window=(gen_window(offsets) if self.dia_mirror
                                    else None),
                    )
            far = None if plan.far is None else spmv_ops.to_device(
                plan.far, dev)
            ring = None if plan.ring is None else [
                spmv_ops.to_device(p, dev) for p in plan.ring]
            self.shards.append(ShardDevice(near, far, ring))
        if self.perm is not None:
            self._perm_dev = tuple(
                torch.as_tensor(p, dtype=torch.int64).to(self.device)
                for p in (self.perm, self._iperm))
        S = self.shard_rows
        self._dst = None
        if self.rank is not None and any(
                nr and r0 != d * S for d, (r0, nr) in enumerate(self.real)):
            # on a process-group mesh, the position of each row of y in the
            # all-gathered shards, where they do not lie back to back (an
            # uneven partition; never halo's)
            self._dst = torch.cat([
                torch.arange(nr) + d * S
                for d, (_, nr) in enumerate(self.real)
            ]).to(self.device)

    @property
    def _mine(self):
        """The shards this process applies: every one, or on a
        process-group mesh its rank's."""
        return range(self.ndev) if self.rank is None else (self.rank,)

    @property
    def capturable(self) -> bool:
        """Whether a caller's CUDA graph can hold an apply: everywhere but
        across several cards of one process, where every B = 1 apply
        replays the operator's own graph (``_capture``), which a caller's
        graph cannot nest, so a solver over this operator runs its loop
        eagerly, one replay an apply (``models/solvers._Operator``)."""
        return self.rank is not None or self.mesh.single_device

    def _all_gather(self, y):
        """The real rows of every rank's (S, ...) ``y``, in row order: one
        all-gather over the process group."""
        out = y.new_empty((self.ndev * y.shape[0],) + tuple(y.shape[1:]))
        # torch 2.11 has only all_gather_into_tensor, which later versions
        # deprecate for all_gather_single
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        gather(out, y.contiguous(), group=self.mesh.group)
        if self._dst is None:
            return out[:self.nrows]
        return torch.index_select(out, 0, self._dst)

    # --- the buffers the operator owns ----------------------------------
    def _window(self, d):
        """Shard d's x as one copy (offset, a, b), x's rows [a, b) into its
        buffer's rows from ``offset`` (empty where b <= a): comm "halo",
        its window ``[H | segment | H]``, x's rows ``[d S - H, d S + S +
        H)`` within x (the halo partition is uniform, so the segments lie
        back to back); else its own rows."""
        r0, nr = self.real[d]
        if self.comm != "halo":
            return 0, r0, r0 + nr
        S, H = self.shard_rows, self.halo_rows
        a = max(d * S - H, 0)
        return a - (d * S - H), a, min(d * S + S + H, self.nrows)

    def _buffers(self, x) -> _Buffers:
        """The buffers of an apply for x's trailing shape and type, made
        (zeros) at the first such x."""
        tail = tuple(x.shape[1:])
        key = (tail, x.dtype)
        if key in self._bufs:
            return self._bufs[key]
        S, H, P = self.shard_rows, self.halo_rows, self.ndev
        devs = self.mesh.row_devices

        def zeros(rows, dev):
            return torch.zeros((rows,) + tail, dtype=x.dtype, device=dev)

        xs, full, ring, ys, fills = ([None] * P for _ in range(5))
        for d in self._mine:
            dev, sh = devs[d], self.shards[d]
            xd = zeros(S + 2 * H if self.comm == "halo" else S, dev)
            o, a, b = self._window(d)
            fd = [(xd[o:o + b - a], a, b)] if b > a else []
            if (self.comm == "gather" and sh.far.has_work
                    and dev != self.device):
                full[d] = zeros(self.nrows, dev)
                fd.append((full[d], 0, self.nrows))
            if self.comm == "ring":
                ring[d] = [xd] + [None] * (P - 1)
                for k in range(1, P):
                    if sh.ring[k].has_work:
                        e0, ne = self.real[(d + k) % P]
                        ring[d][k] = zeros(S, dev)
                        fd.append((ring[d][k][:ne], e0, e0 + ne))
            xs[d], ys[d], fills[d] = xd, zeros(S, dev), fd
        row = x.element_size() * math.prod(tail)
        moved = row * sum(
            sum(b - a for _, a, b in fills[d]) + self.real[d][1]
            for d in self._mine if devs[d] != self.device)
        self._bufs[key] = _Buffers(xs, full, ring, ys, fills, moved)
        return self._bufs[key]

    def _operands(self, x, bufs, d):
        """Shard d's own x segment, ``far(k)``, the x its far stream
        (ring: step k's) reads, and the tensor its y is written into
        where y is a sum or zero, from the buffers (``_Buffers``) that the
        scatter filled."""
        xd, out = bufs.xs[d], bufs.ys[d]
        if self.comm == "ring":
            return xd, bufs.ring[d].__getitem__, out
        if self.comm == "halo":
            S, H = self.shard_rows, self.halo_rows
            return xd[H:H + S], lambda k: xd, out
        far = x if bufs.full[d] is None else bufs.full[d]
        return xd, lambda k: far, out

    def _across(self, shards, x, bufs, y=None, plain=False, streams=None):
        """An apply over ``bufs``: the scatter (each shard's fills from x,
        on the first device), each shard's streams, then each shard's rows
        of y copied into ``y`` there (None: a new one), or on a
        process-group mesh the all-gather of every rank's rows. Returns y.

        ``streams`` (the capture): each card's stream, and for each other
        card a stream of the first card that holds the copies to and from
        it (a copy between two cards runs on its source card's current
        stream and orders both cards' current streams around itself), so
        that no copy waits for another card's kernels; None: the current
        streams."""
        devs = self.mesh.row_devices
        apply = self._shard_apply if x.ndim == 1 else self._shard_apply_mm

        def beside(dev):
            if streams is None or dev == self.device:
                return contextlib.nullcontext()
            return torch.cuda.stream(streams[1][dev])

        with contextlib.ExitStack() as current:
            for s in streams[0].values() if streams else ():
                current.enter_context(torch.cuda.stream(s))
            with trace.span("cfs.dist.scatter"):
                for d in self._mine:
                    with trace.span("cfs.dist.exchange", comm=self.comm), \
                            beside(devs[d]):
                        for dst, a, b in bufs.fills[d]:
                            dst.copy_(x[a:b])
            ys = {}
            for d in self._mine:
                with trace.span("cfs.dist.shard", shard=d,
                                device=str(devs[d])):
                    ys[d] = apply(shards[d], d, x, bufs, plain)
            with trace.span("cfs.dist.gather"):
                if self.rank is not None:
                    return self._all_gather(ys[self.rank])
                y = x.new_empty(x.shape) if y is None else y
                for d, yd in ys.items():
                    r0, nr = self.real[d]
                    if nr:
                        with beside(devs[d]):
                            y[r0:r0 + nr].copy_(yd[:nr])
                return y

    def _capture(self):
        """The B = 1 apply across the mesh's cards as one CUDA graph
        (``_Graph``), captured after one eager apply over the same
        buffers (which builds and loads every kernel): each card's stream
        and each other card's stream of the first card (``_across``) are
        forked from the capturing stream and joined to it at the end. The
        temporaries of the shards on the first card go to the graph's
        pool, those on another card to a pool of the operator's there
        (``torch.cuda.MemPool``), held as long as the graph. A capture
        that the cards refuse raises."""
        first = self.device
        cards = list(dict.fromkeys(self.mesh.row_devices))
        x = torch.zeros(self.nrows, dtype=self.dtype, device=first)
        bufs = self._buffers(x)
        bufs.x, bufs.y = x, torch.empty_like(x)
        self._across(self.shards, bufs.x, bufs, bufs.y)
        for card in cards:
            torch.cuda.synchronize(card)
        streams = ({c: torch.cuda.Stream(c) for c in cards},
                   {c: torch.cuda.Stream(first) for c in cards if c != first})
        forked = [*streams[0].values(), *streams[1].values()]
        pools = {}
        for c in cards[1:]:
            with torch.cuda.device(c):
                pools[c] = torch.cuda.MemPool()
        graph = torch.cuda.CUDAGraph()
        try:
            with contextlib.ExitStack() as stack:
                for c, pool in pools.items():
                    stack.enter_context(torch.cuda.use_mem_pool(pool, c))
                stack.enter_context(torch.cuda.device(first))
                stack.enter_context(torch.cuda.graph(
                    graph, stream=torch.cuda.Stream(first)))
                capturing = torch.cuda.current_stream()
                for s in forked:
                    s.wait_stream(capturing)
                self._across(self.shards, bufs.x, bufs, bufs.y,
                             streams=streams)
                for s in forked:
                    capturing.wait_stream(s)
        except RuntimeError as err:
            raise RuntimeError(
                f"CUDA graph capture across cards failed: {err}") from err
        self._graph = _Graph(graph, bufs, list(pools.values()))
        trace.count("dist.graph_captures", 1)

    def _replay(self, x):
        """x into the graph's input, one replay, and a copy of its y."""
        g = self._graph
        g.bufs.x.copy_(x)
        g.graph.replay()
        trace.count("dist.copy_bytes", g.bufs.moved)
        trace.count("dist.graph_replays", 1)
        return g.bufs.y.clone()

    # ------------------------------------------------------------------
    def _shard_apply(self, sh, d, x, bufs, plain):
        """Shard d's y (S,) from the global x and the buffers: its near
        streams over its own segment, its far stream over the x that
        ``_operands`` names."""
        f = spmv_ops._kernels(plain, self.dtype)
        x_loc, far, out = self._operands(x, bufs, d)
        y = (None if sh.near is None
             else spmv_ops.sbell_apply(sh.near, x_loc, plain=plain))
        if self.comm == "ring":
            tiles = (y if y is not None else out.zero_()).view(-1, LANES)
            for k, st in enumerate(sh.ring):
                if st.has_work:
                    # the segment is whole tiles of 128: the entries read
                    # it in place
                    f["bell2_acc"](st.entries, far(k).view(-1, LANES), tiles)
            return tiles.view(-1)
        if sh.far.has_work:
            yf = spmv_ops.bell2_apply(sh.far, far(None), plain=plain)
            y = yf if y is None else torch.add(y, yf, out=out)
        return y if y is not None else out.zero_()

    def _shard_apply_mm(self, sh, d, x, bufs, plain):
        """Shard d's Y (S, B), as :meth:`_shard_apply` over B columns."""
        f = spmv_ops._kernels(plain, self.dtype)
        x_loc, far, out = self._operands(x, bufs, d)
        B = x_loc.shape[1]
        y = (None if sh.near is None
             else spmv_ops.sbell_apply_mm(sh.near, x_loc, plain=plain))
        yf = None
        if self.comm == "ring":
            T = self.shard_rows // LANES
            tiles = x_loc.new_zeros((B, T, LANES))
            for k, st in enumerate(sh.ring):
                if st.has_work:
                    x3d = spmv_ops.pad_x_mm(far(k), T)
                    f["bell2_acc_mm"](st.entries, x3d, tiles)
            yf = tiles.view(B, -1).T
        elif sh.far.has_work:
            yf = spmv_ops.bell2_apply_mm(sh.far, far(None), plain=plain)
        if yf is None:
            return y if y is not None else out.zero_()
        return yf if y is None else torch.add(y, yf, out=out)

    def _run(self, shards, x, plain=False):
        """The global y (n, ...) on the mesh's first device from the
        global (internal-space) x there: a replay of the captured apply
        where the operator holds one and x is its key, else the scatter,
        every shard's apply and the gather over the buffers of x's key
        (``_across``)."""
        devs = self.mesh.row_devices
        rhs = x.shape[1] if x.ndim == 2 else 1
        with trace.span("cfs.dist.apply", rhs=rhs, comm=self.comm,
                        cards=len(set(devs))):
            g = self._graph
            if (g is not None and not plain and x.shape == g.bufs.x.shape
                    and x.dtype == g.bufs.x.dtype):
                with trace.span("cfs.dist.replay"):
                    return self._replay(x)
            bufs = self._buffers(x)
            y = self._across(shards, x, bufs, plain=plain)
            if bufs.moved:
                trace.count("dist.copy_bytes", bufs.moved)
            return y

    # ------------------------------------------------------------------
    def _as_x(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def matmat(self, X):
        """Y = A @ X for X of shape (ncols, B)."""
        X = self._as_x(X)
        if X.ndim != 2 or X.shape[0] != self.ncols or X.shape[1] < 1:
            raise ValueError(
                f"X must be ({self.ncols}, B), got {tuple(X.shape)}"
            )
        return self.decode(self._run(self.shards,
                                     self.encode(X).contiguous()))

    def __call__(self, x):
        x = self._as_x(x)
        if x.ndim == 2:
            return self.matmat(x)
        if tuple(x.shape) != (self.ncols,):
            raise ValueError(
                f"x must be ({self.ncols},), got {tuple(x.shape)}")
        return self.decode(self._run(self.shards,
                                     self.encode(x).contiguous()))

    # --- pure-apply protocol (see utils.timing.as_pure) ----------------
    def pure_apply(self):
        """(fn, operands): fn(operands, x, plain=False) applies the
        shards to an internal-space x; ``plain`` runs the kernels' plain
        twins (the solvers' comparison mode)."""
        return self._run, self.shards

    def pure_apply_mm(self):
        """Multi-RHS pure applier: fn(operands, X) for X (ncols, B)."""
        return self._run, self.shards

    @property
    def far_fraction(self) -> float:
        """Fraction of logical nonzeros needing a remote x value — the
        halo volume that the weak-scaling model is gated on."""
        return self.far_nnz / max(self.nnz_full, 1)

    def encode(self, x):
        """User space → internal (cluster-permuted) space; identity when
        assign='contiguous' or clustering was rejected."""
        if self.perm is None:
            return x
        return torch.index_select(x, 0, self._perm_dev[0].to(x.device))

    def decode(self, y):
        if self.perm is None:
            return y
        return torch.index_select(y, 0, self._perm_dev[1].to(y.device))
