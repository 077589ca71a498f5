"""The stiffness matrix of 3-D linear elasticity with trilinear elements
(deal.II's step-8 at ``dim = 3``: ``FESystem(FE_Q(1), 3)``, ``QGauss(2)``)
on the cube ``domain``^3 refined ``refine`` times (``ne = 2^refine``
cells a side), with zero Dirichlet data on the whole boundary, as its
lower triangle (the diagonal included) in CSR with columns ascending.

The DoF numbering is ``DoFHandler::distribute_dofs`` on a p4est
``parallel::distributed::Triangulation`` of one tree: the cells are
visited in p4est's z-order (Morton order, the bits of the cell's x, y and
z interleaved with x lowest); each cell's 8 vertices are taken in deal.II's
lexicographic order (x fastest); a vertex not yet numbered gets the next
3 DoF indices, its x, y and z components side by side.

The element matrix is the same for every cell of the uniform mesh:
``K_e = sum_q B^T D B |J| w`` over the 2 x 2 x 2 Gauss points, in float64,
B's rows the strains (xx, yy, zz, xy, yz, zx) with engineering shears, D
the isotropic law with Lame's ``lambda`` and ``mu``. The stored pattern is
deal.II's sparsity pattern with the constraints and
``keep_constrained_dofs = false``: every coupling of two free DoFs that
share a cell (81 in an interior row, whatever its value, zeros included),
and each constrained DoF's diagonal alone. A constrained DoF keeps its
assembled diagonal; deal.II would store the mean of the free diagonal
there instead (``AffineConstraints::distribute_local_to_global``), a
departure the configuration lists under ``assumed``.

The assembly runs by node and neighbour offset, never by element triplet:
the block that couples a node with the node at offset d in {-1, 0, 1}^3 is
the sum, over the up to 8 cells that hold both, of the element matrix's
3 x 3 block of the two vertices' places in that cell, added in a fixed
order with int64 and float64 ``torch`` operations, on the card where there
is one (``device``), else on the CPU: the same bits on either. The matrix
is a function of the configuration alone.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

#: the 27 neighbour offsets (dx, dy, dz), x fastest
OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
#: nodes assembled at a time
CHUNK = 1 << 18


def vertex_place(u) -> int:
    """A vertex's place in a cell, deal.II's lexicographic order: u = (ux,
    uy, uz) in {0, 1}^3 from the cell's lowest corner."""
    return u[0] + 2 * u[1] + 4 * u[2]


def element_matrix(h: float, lam: float, mu: float) -> np.ndarray:
    """The 24 x 24 stiffness matrix of a cube cell of side ``h``, DoF
    ``3 * place + component``: B^T D B over 2 x 2 x 2 Gauss points."""
    g = (1 - 1 / np.sqrt(3)) / 2, (1 + 1 / np.sqrt(3)) / 2  # on [0, 1]
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[[0, 1, 2], [0, 1, 2]] += 2 * mu
    d[[3, 4, 5], [3, 4, 5]] = mu
    k = np.zeros((24, 24))
    for q in itertools.product(g, g, g):
        b = np.zeros((6, 24))
        for a in range(8):
            u = (a & 1, (a >> 1) & 1, a >> 2)
            f = [q[i] if u[i] else 1 - q[i] for i in range(3)]
            s = [1.0 if u[i] else -1.0 for i in range(3)]
            gx, gy, gz = (s[i] * f[(i + 1) % 3] * f[(i + 2) % 3] / h
                          for i in range(3))
            c = 3 * a
            b[0, c], b[1, c + 1], b[2, c + 2] = gx, gy, gz
            b[3, c], b[3, c + 1] = gy, gx
            b[4, c + 1], b[4, c + 2] = gz, gy
            b[5, c], b[5, c + 2] = gz, gx
        k += b.T @ d @ b * (h**3 / 8)
    return k


def z_order_cells(ne: int, device) -> tuple[torch.Tensor, ...]:
    """The cells' (x, y, z) in p4est's visiting order: cell t of the order
    has its x, y and z in bits 0, 1 and 2 of each 3-bit group of t."""
    t = torch.arange(ne**3, dtype=torch.int64, device=device)
    xyz = [torch.zeros_like(t) for _ in range(3)]
    for b in range(ne.bit_length() - 1):
        for i in range(3):
            xyz[i] |= ((t >> (3 * b + i)) & 1) << b
    return tuple(xyz)


def numbering(ne: int, device) -> torch.Tensor:
    """Each vertex's node number (vertex ``x + (ne + 1) (y + (ne + 1)
    z)``): the rank of its first visit, cells in z-order and each cell's
    vertices in lexicographic order."""
    m = ne + 1
    cx, cy, cz = z_order_cells(ne, device)
    seq = torch.stack([(cx + (a & 1)) + m * ((cy + ((a >> 1) & 1))
                                             + m * (cz + (a >> 2)))
                       for a in range(8)], dim=1).reshape(-1)
    first = torch.full((m**3,), seq.numel(), dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, seq, torch.arange(seq.numel(), device=device),
                          "amin")
    node = torch.empty_like(first)
    node[torch.argsort(first)] = torch.arange(m**3, device=device)
    return node


def _blocks(x, y, z, ne: int, k: torch.Tensor) -> torch.Tensor:
    """(nodes, 27, 3, 3): the coupling blocks of the vertices (x, y, z)
    with their 27 neighbours, summed over the cells that hold both."""
    # the cell at a in {-1, 0}^3 from a vertex lies in the mesh
    inside = [[(c + a >= 0) & (c + a <= ne - 1) for a in (-1, 0)]
              for c in (x, y, z)]
    out = torch.zeros((x.numel(), 27, 3, 3), dtype=torch.float64,
                      device=x.device)
    for j, d in enumerate(OFFSETS):
        for a in itertools.product((-1, 0), repeat=3):
            there = tuple(d[i] - a[i] for i in range(3))
            if not all(t in (0, 1) for t in there):
                continue
            p = 3 * vertex_place([-a[0], -a[1], -a[2]])
            q = 3 * vertex_place(there)
            held = (inside[0][a[0] + 1] & inside[1][a[1] + 1]
                    & inside[2][a[2] + 1])
            out[:, j] += torch.where(held[:, None, None], k[p:p + 3, q:q + 3],
                                     0.0)
    return out


def make(cfg: dict, device=None):
    """(n, indptr int64, indices int32, data float64) of ``cfg``:
    ``refine``, ``lambda``, ``mu`` and ``domain`` ([lo, hi]). Runs on
    ``device`` (default: the card where there is one, else the CPU); the
    matrix is the same on either."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    ne = 1 << int(cfg["refine"])
    lo, hi = (float(v) for v in cfg["domain"])
    k = torch.as_tensor(element_matrix((hi - lo) / ne, float(cfg["lambda"]),
                                       float(cfg["mu"])), device=device)
    m = ne + 1
    node = numbering(ne, device)
    by_node = torch.argsort(node)  # each node's vertex
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=device)
    centre = OFFSETS.index((0, 0, 0))
    same = torch.eye(3, dtype=torch.bool, device=device)
    counts, cols, vals = [], [], []
    for n0 in range(0, m**3, CHUNK):
        v = by_node[n0:n0 + CHUNK]
        xyz = torch.stack([v % m, (v // m) % m, v // (m * m)], dim=1)
        nb = xyz[:, None, :] + off  # (nodes, 27, 3)
        valid = ((nb >= 0) & (nb <= ne)).all(dim=2)
        fixed = ((xyz == 0) | (xyz == ne)).any(dim=1)
        nb_fixed = ((nb == 0) | (nb == ne)).any(dim=2)
        nb_node = node[(nb[..., 0] + m * (nb[..., 1] + m * nb[..., 2]))
                       .clamp(0, m**3 - 1)]
        keep = valid & ~nb_fixed & ~fixed[:, None]
        keep[:, centre] |= fixed  # a constrained DoF's own block
        nb_node = torch.where(keep, nb_node, m**3)
        nb_node, order = torch.sort(nb_node, dim=1)
        blk = _blocks(*xyz.T, ne, k).gather(
            1, order[:, :, None, None].expand(-1, -1, 3, 3))
        keep = keep.gather(1, order)
        rows = 3 * torch.arange(n0, n0 + v.numel(), device=device)
        # (nodes, 3 row components, 27, 3 column components)
        col = (3 * nb_node[:, None, :, None]
               + torch.arange(3, device=device)[None, None, None, :]
               ).expand(-1, 3, -1, -1)
        row = (rows[:, None] + torch.arange(3, device=device))[:, :, None,
                                                               None]
        live = (keep[:, None, :, None] & (col <= row)
                & (same[None, :, None, :] | ~fixed[:, None, None, None]))
        counts.append(live.sum(dim=(2, 3)).reshape(-1).cpu())
        cols.append(col[live].int().cpu())
        vals.append(blk.permute(0, 2, 1, 3)[live].cpu())
    n = 3 * m**3
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.cat(counts).numpy(), out=indptr[1:])
    return (n, indptr, torch.cat(cols).numpy(), torch.cat(vals).numpy())
