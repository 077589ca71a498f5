"""Locality-aware row→device assignment (the METIS/KaHIP analog).

Host copy of ``cfs_spmv_tpu/tuning/cluster.py`` for the PyTorch port.

The reference's ``partition_by_conflicts`` hands the 16-row-block
conflict graph to METIS/KaHIP for a k-way min-edge-cut partition
(``csr_matrix.tpp:543-639``) so that threads rarely write into each
other's rows. At mesh scale the analogous cost is the *far stream*: a
nonzero whose column lives on another device forces halo traffic over
ICI/DCN. SURVEY §2's parallelism table owes an optional locality-aware
assignment minimizing that traffic.

The device shards must stay contiguous 128-row-tile ranges (the whole
plan/kernel stack is built on tile-aligned slabs), so locality is
achieved by *permutation*: greedy graph-growing clustering on the tile
quotient graph produces a tile ordering whose contiguous equal-work cuts
have a small edge cut, and the rows are symmetrically permuted so that
clusters land on contiguous shards. This mirrors what METIS's partition
would give, expressed as P A Pᵀ — the same trick ``tune(reorder=...)``
uses for bandwidth (RCM), aimed at cut size instead of envelope.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..utils.logging import info

__all__ = ["tile_quotient_graph", "cluster_tile_order", "cut_weight",
           "choose_cluster_assignment"]

LANES = 128


def tile_quotient_graph(csr):
    """Adjacency of the 128-row-tile quotient graph.

    Returns ``(indptr, nbr, w, tile_nnz)``: CSR adjacency over tiles with
    edge weights = nonzeros between the two tiles (both triangles for
    symmetric storage), and per-tile total nonzeros (the balance weight).
    """
    T = max(1, -(-csr.nrows // LANES))
    rowlen = np.diff(csr.indptr)
    row = np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen)
    col = csr.indices.astype(np.int64)
    tr, tc = row >> 7, col >> 7
    if csr.symmetric:  # mirror the stored triangle
        tr, tc = np.concatenate([tr, tc]), np.concatenate([tc, tr])
    tile_nnz = np.bincount(tr, minlength=T)
    off = tr != tc
    key = tr[off] * T + tc[off]
    uniq, w = np.unique(key, return_counts=True)
    a, b = uniq // T, uniq % T
    indptr = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(a, minlength=T), out=indptr[1:])
    return indptr, b, w.astype(np.int64), tile_nnz


def cluster_tile_order(csr, ndev: int) -> np.ndarray:
    """Tile ordering whose ``ndev`` contiguous equal-work cuts minimize
    the edge cut (greedy graph growing with a max-gain heap).

    Each cluster grows from a seed weakly connected to what is already
    assigned, repeatedly absorbing the unassigned tile with the largest
    connection to the cluster, until it holds ~1/ndev of the nonzeros.
    Returns the tile permutation (new position → old tile id).
    """
    indptr, nbr, w, tile_nnz = tile_quotient_graph(csr)
    T = len(tile_nnz)
    total = int(tile_nnz.sum())
    target = total / max(ndev, 1)
    assigned = np.zeros(T, bool)
    conn = np.zeros(T, np.int64)  # connection weight to CURRENT cluster
    order = np.empty(T, np.int64)
    pos = 0
    scan = 0  # seed scan pointer (first unassigned tile in index order)

    for d in range(ndev):
        while scan < T and assigned[scan]:
            scan += 1
        if scan >= T:
            break
        seed = scan
        conn[:] = 0
        heap: list[tuple[int, int]] = []
        work = 0
        cur = seed
        while True:
            assigned[cur] = True
            order[pos] = cur
            pos += 1
            work += int(tile_nnz[cur])
            if work >= target and d < ndev - 1:
                break
            for j in range(indptr[cur], indptr[cur + 1]):
                u = nbr[j]
                if not assigned[u]:
                    conn[u] += w[j]
                    heapq.heappush(heap, (-int(conn[u]), int(u)))
            cur = -1
            while heap:
                negc, u = heapq.heappop(heap)
                if not assigned[u] and conn[u] == -negc:  # fresh entry
                    cur = u
                    break
            if cur < 0:  # cluster's component exhausted: jump to the
                while scan < T and assigned[scan]:  # next unassigned
                    scan += 1
                if scan >= T:
                    break
                cur = scan
    # any tail (ndev clusters filled early): keep index order
    if pos < T:
        rest = np.flatnonzero(~assigned)
        order[pos:] = rest
    return order


def cut_weight(csr, bounds_tiles: np.ndarray, tile_of: np.ndarray | None
               = None) -> int:
    """Nonzeros whose row tile and column tile land on different devices
    under contiguous tile ``bounds`` (optionally after a tile
    permutation given as ``tile_of`` = old tile → new position)."""
    rowlen = np.diff(csr.indptr)
    row = np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen)
    col = csr.indices.astype(np.int64)
    tr, tc = row >> 7, col >> 7
    if tile_of is not None:
        tr, tc = tile_of[tr], tile_of[tc]
    dr = np.searchsorted(bounds_tiles[1:-1], tr, side="right")
    dc = np.searchsorted(bounds_tiles[1:-1], tc, side="right")
    m = int(np.count_nonzero(dr != dc))
    if csr.symmetric:
        m *= 2  # mirrored entries cross the same cut
    return m


def choose_cluster_assignment(csr, ndev: int):
    """(row_perm, permuted_csr) when clustering reduces the cross-device
    cut of the equal-nnz contiguous partition, else None.

    The comparison uses the same partitioner the distributor applies, so
    "better" means the far stream the device plans would actually see.
    """
    from ..formats.coo import COO
    from ..formats.csr import CSR
    from ..tuning.partition import partition_tiles_by_nnz, tile_nnz_histogram

    T = max(1, -(-csr.nrows // LANES))
    if T < 2 * ndev or csr.nnz == 0:
        return None

    def bounds_for(c):
        hist = tile_nnz_histogram(c.indptr, T)
        if c.symmetric:
            rowlen = np.diff(c.indptr)
            colt = c.indices.astype(np.int64) >> 7
            hist = hist + np.bincount(colt, minlength=T)
        return partition_tiles_by_nnz(hist, ndev)

    cut0 = cut_weight(csr, bounds_for(csr))
    tile_order = cluster_tile_order(csr, ndev)
    if csr.nrows % LANES:
        # a ragged final tile must stay last or every later tile slot
        # would shift off its 128-row boundary
        tile_order = np.concatenate(
            [tile_order[tile_order != T - 1], [T - 1]]
        )
    tile_of = np.empty(T, np.int64)
    tile_of[tile_order] = np.arange(T)

    # row permutation realizing the tile ordering (tail rows of a ragged
    # last tile stay with their tile)
    rows_of_tile = [
        np.arange(t * LANES, min((t + 1) * LANES, csr.nrows))
        for t in tile_order
    ]
    perm = np.concatenate(rows_of_tile)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))

    coo = csr.to_coo()
    r = iperm[coo.row.astype(np.int64)]
    c = iperm[coo.col.astype(np.int64)]
    if csr.symmetric:
        swap = c > r
        r[swap], c[swap] = c[swap], r[swap].copy()
    permuted = CSR.from_coo(
        COO(csr.nrows, csr.ncols, r, c, coo.val.copy(), csr.symmetric)
    )
    cut1 = cut_weight(permuted, bounds_for(permuted))
    if cut1 >= cut0:
        info("cluster: rejected (cut %d -> %d)", cut0, cut1)
        return None
    info("cluster: accepted (cut %d -> %d, %.2fx)", cut0, cut1,
         cut0 / max(cut1, 1))
    return perm, permuted
