"""The Graph500 Kronecker graph's normalized-adjacency operator
M = I - alpha D^-1/2 A D^-1/2, as its lower triangle (the diagonal
included) in CSR with columns ascending.

The graph follows the Graph500 specification's Kernel 0 and its reference
``kronecker_generator.m``: 2^scale vertices, edgefactor x 2^scale edges,
each edge's endpoints drawn bit by bit over ``scale`` levels with the
initiator (A, B, C, D): at each level ``ii_bit = u1 > A + B`` and
``jj_bit = u2 > (C / (1 - A - B) if ii_bit else A / (A + B))``; then the
vertex labels are randomly permuted. The graph is made undirected: self
loops are dropped, and both directions and duplicates of an edge merge
into one lower-triangle entry. D holds each vertex's degree after the
merge; an isolated vertex keeps its unit diagonal alone.

Departures from ``kronecker_generator.m``, neither of which changes what
the matrix is a draw of:

- the random stream: every uniform is a counter-based hash (splitmix64's
  finaliser of ``graph_seed``'s key plus the draw's counter times the
  golden-ratio increment), compared as a 53-bit integer with the
  threshold's 53-bit floor, so that the CPU and the card draw the same
  bits; the label permutation is the stable sort of one more stream of
  such hashes;
- the final shuffle of the edge list is left out: it reorders edges, and
  the matrix is a set of entries.

The draws and the merge run in int64 ``torch`` operations on the card
where there is one (``device``), else on the CPU; the values are computed
on the host in float64 and rounded once to float32.
"""

from __future__ import annotations

import numpy as np
import torch

#: splitmix64's constants, as the signed 64-bit integers of their bits
GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
MIX2 = 0x94D049BB133111EB - (1 << 64)


def _shr(z: torch.Tensor, k: int) -> torch.Tensor:
    """The logical right shift of int64 ``z``'s 64 bits by ``k``."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 bits (products wrap mod 2^64)."""
    z = (z ^ _shr(z, 30)) * MIX1
    z = (z ^ _shr(z, 27)) * MIX2
    return z ^ _shr(z, 31)


def seed_key(graph_seed: int) -> int:
    """The stream's key of ``graph_seed``: splitmix64 of the seed, as a
    signed 64-bit integer."""
    z = (graph_seed + GOLDEN) % (1 << 64)
    z = ((z ^ (z >> 30)) * (MIX1 % (1 << 64))) % (1 << 64)
    z = ((z ^ (z >> 27)) * (MIX2 % (1 << 64))) % (1 << 64)
    z ^= z >> 31
    return z - (1 << 64) if z >> 63 else z


def draws(key: int, start: int, count: int, device) -> torch.Tensor:
    """The 53-bit integers of draws ``start`` to ``start + count - 1`` of
    the stream ``key``: u = draw / 2^53 is uniform in [0, 1)."""
    ctr = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    return _shr(_mix(ctr * GOLDEN + key), 11)


def threshold(p: float) -> int:
    """The integer t for which u > p is draw > t (u = draw / 2^53)."""
    return int(np.floor(p * 2.0**53))


def edges(scale: int, edgefactor: int, initiator, graph_seed: int,
          device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The edge list (i, j) before the merge: int64 vertex labels in
    [0, 2^scale), edgefactor x 2^scale of them, the labels permuted.
    Stream ``2 * level`` draws the level's ``ii_bit``, ``2 * level + 1``
    its ``jj_bit``, and ``2 * scale`` the permutation's sort keys; draw
    ``e`` of stream ``s`` is counter ``s * M + e``."""
    a, b, c, _ = (float(v) for v in initiator)
    n, m = 1 << scale, edgefactor << scale
    key = seed_key(graph_seed)
    t_ab = threshold(a + b)
    t_c = threshold(c / (1 - (a + b)))
    t_a = threshold(a / (a + b))
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        ii = draws(key, 2 * level * m, m, device) > t_ab
        t_j = torch.where(ii, t_c, t_a)
        jj = draws(key, (2 * level + 1) * m, m, device) > t_j
        i |= ii.long() << level
        j |= jj.long() << level
    perm = torch.sort(draws(key, 2 * scale * m, n, device), stable=True)[1]
    return perm[i], perm[j]


def merged(i: torch.Tensor, j: torch.Tensor, n: int) -> np.ndarray:
    """The undirected graph's distinct edges, each once as
    ``row * n + col`` with row > col, ascending (row-major, columns
    ascending), on the host: self loops dropped, both directions and
    duplicates merged."""
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.maximum(i, j) * n + torch.minimum(i, j)
    return torch.unique(key, sorted=True).cpu().numpy()


def make(cfg: dict, device=None):
    """(n, indptr int64, indices int32, data float32) of ``cfg``:
    ``scale``, ``edgefactor``, ``initiator`` (A, B, C, D), ``alpha`` and
    ``graph_seed``. The draws run on ``device`` (default: the card where
    there is one, else the CPU); the matrix is the same on either."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    scale = int(cfg["scale"])
    n = 1 << scale
    i, j = edges(scale, int(cfg["edgefactor"]), cfg["initiator"],
                 int(cfg["graph_seed"]), device)
    keys = merged(i, j, n)
    del i, j
    rows, cols = np.divmod(keys, n)
    deg = (np.bincount(rows, minlength=n)
           + np.bincount(cols, minlength=n)).astype(np.float64)
    off = (-float(cfg["alpha"]) / np.sqrt(deg[rows] * deg[cols])).astype(
        np.float32)
    # each row's entries below the diagonal, then its unit diagonal: an
    # entry moves up by one slot for each earlier row's diagonal
    per_row = np.bincount(rows, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(per_row + 1, out=indptr[1:])
    nnz = len(keys) + n
    indices = np.empty(nnz, np.int32)
    data = np.empty(nnz, np.float32)
    at = np.arange(len(keys), dtype=np.int64) + rows
    indices[at] = cols
    data[at] = off
    diag = indptr[1:] - 1
    indices[diag] = np.arange(n, dtype=np.int32)
    data[diag] = 1.0
    return n, indptr, indices, data
