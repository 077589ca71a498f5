"""The plain reference of ``dealii-elasticity-q1``: deal.II step-8's
operator applied cell by cell, in float64, with plain PyTorch operations,
independent of the benchmark's generator and of the program.

It numbers the DoFs itself (the cells sorted by their interleaved Morton
code, x lowest; each vertex numbered at its first visit, found by a
stable sort) and computes the element matrix from step-8's bilinear form,
``lambda (d_ci phi_i)(d_cj phi_j) + mu (d_cj phi_i)(d_ci phi_j) +
delta_ci,cj mu grad phi_i . grad phi_j``, over 2 x 2 x 2 Gauss points.
``matvec(x)`` is ``sum_e P_e^T K_e P_e x`` over blocks of cells with the
constrained DoFs of x zeroed, then each constrained DoF's row replaced by
its assembled diagonal times x. ``matvec(x, absolute=True)`` is
``|A| |x|`` from the benchmark's own lower-triangle CSR, which only scales
the error. Lame's constants and the domain are the configuration file's;
the mesh's size is read off the matrix's order, ``n = 3 (ne + 1)^3``.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "dealii-elasticity-q1.json")
#: cells a block of the product
BLOCK = 1 << 18


def stiffness(h: float, lam: float, mu: float) -> torch.Tensor:
    """step-8's cell matrix of a cube of side ``h``, DoF ``3 * vertex +
    component``, vertices in lexicographic order."""
    pts = [(1 + s / np.sqrt(3)) / 2 for s in (-1, 1)]
    corner = [(v & 1, (v >> 1) & 1, v >> 2) for v in range(8)]
    k = np.zeros((24, 24))
    for q in itertools.product(pts, pts, pts):
        grad = np.empty((8, 3))
        for v, c in enumerate(corner):
            hat = [q[i] if c[i] else 1 - q[i] for i in range(3)]
            for i in range(3):
                grad[v, i] = ((1 if c[i] else -1) * np.prod(hat[:i] + hat[i + 1:])
                              / h)
        w = h**3 / 8
        for i, j in itertools.product(range(24), range(24)):
            (a, ci), (b, cj) = divmod(i, 3), divmod(j, 3)
            k[i, j] += w * (lam * grad[a, ci] * grad[b, cj]
                            + mu * grad[a, cj] * grad[b, ci]
                            + (mu * grad[a] @ grad[b] if ci == cj else 0.0))
    return torch.as_tensor(k)


def cell_dofs(ne: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cells, 24) DoFs of each cell, and the constrained DoFs (a mask)."""
    m = ne + 1
    c = torch.arange(ne, device=device)
    cz, cy, cx = torch.meshgrid(c, c, c, indexing="ij")
    cx, cy, cz = cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)
    code = torch.zeros_like(cx)
    for b in range(ne.bit_length()):
        for i, axis in enumerate((cx, cy, cz)):
            code |= ((axis >> b) & 1) << (3 * b + i)
    order = torch.argsort(code)
    cx, cy, cz = cx[order], cy[order], cz[order]
    verts = torch.stack([cx + dx + m * (cy + dy + m * (cz + dz))
                         for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                        dim=1)
    seq = verts.reshape(-1)
    sorted_v, pos = torch.sort(seq, stable=True)
    start = torch.ones_like(sorted_v, dtype=torch.bool)
    start[1:] = sorted_v[1:] != sorted_v[:-1]
    first = torch.empty(m**3, dtype=torch.int64, device=device)
    first[sorted_v[start]] = pos[start]
    node = torch.empty_like(first)
    node[torch.argsort(first)] = torch.arange(m**3, device=device)
    dofs = (3 * node[verts][:, :, None]
            + torch.arange(3, device=device)).reshape(-1, 24)
    v = torch.arange(m**3, device=device)
    on_edge = torch.zeros(m**3, dtype=torch.bool, device=device)
    for coord in (v % m, (v // m) % m, v // (m * m)):
        on_edge |= (coord == 0) | (coord == ne)
    fixed = torch.zeros(3 * m**3, dtype=torch.bool, device=device)
    fixed.view(-1, 3)[node[on_edge]] = True
    return dofs, fixed


class Reference:
    """``A x`` of ``dealii-elasticity-q1`` whose benchmark matrix is
    ``mat`` (its lower-triangle CSR), on ``device``; ``cfg`` (default: the
    configuration file) gives ``lambda``, ``mu`` and ``domain``."""

    def __init__(self, mat, device, cfg: dict | None = None):
        if cfg is None:
            with open(CONFIG) as f:
                cfg = json.load(f)
        ne = round((mat.n // 3) ** (1 / 3)) - 1
        if 3 * (ne + 1) ** 3 != mat.n or ne & (ne - 1):
            raise ValueError(f"{mat.n} rows are no mesh of 2^k cells a side")
        lo, hi = cfg["domain"]
        self.n = mat.n
        self.k = stiffness((hi - lo) / ne, cfg["lambda"], cfg["mu"]).to(device)
        self.dofs, self.fixed = cell_dofs(ne, device)
        self.diag = torch.zeros(mat.n, dtype=torch.float64, device=device)
        self.diag.index_add_(0, self.dofs.reshape(-1),
                             self.k.diagonal().repeat(self.dofs.shape[0]))
        # |A| from the benchmark's triangle, each entry off the diagonal
        # mirrored
        self.row = torch.repeat_interleave(
            torch.arange(mat.n, device=device),
            torch.as_tensor(np.diff(mat.indptr), device=device))
        self.col = torch.as_tensor(mat.indices, device=device).long()
        self.abs_val = torch.as_tensor(mat.data, device=device).abs()

    def matvec(self, x: torch.Tensor, absolute: bool = False):
        """A x, or |A| |x| with ``absolute``, in float64; x (n,) or
        (n, B)."""
        x = x.to(torch.float64)
        if absolute:
            return self._abs(x.abs())
        xm = torch.where(self.fixed.view(-1, *[1] * (x.ndim - 1)), 0.0, x)
        y = torch.zeros_like(x)
        for c0 in range(0, self.dofs.shape[0], BLOCK):
            d = self.dofs[c0:c0 + BLOCK]
            ye = torch.einsum("ij,cj...->ci...", self.k, xm[d])
            y.index_add_(0, d.reshape(-1), ye.reshape(-1, *x.shape[1:]))
        fixed = self.fixed
        y[fixed] = self.diag[fixed].view(-1, *[1] * (x.ndim - 1)) * x[fixed]
        return y

    def _abs(self, ax: torch.Tensor) -> torch.Tensor:
        w = self.abs_val.view(-1, *[1] * (ax.ndim - 1))
        y = torch.zeros_like(ax)
        y.index_add_(0, self.row, w * ax[self.col])
        off = self.row != self.col
        y.index_add_(0, self.col[off], w[off] * ax[self.row[off]])
        return y

    def cg(self, b: torch.Tensor, iters: int) -> torch.Tensor:
        """``iters`` iterations of unpreconditioned CG from x = 0."""
        b = b.to(torch.float64)
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rs = torch.dot(r, r)
        for _ in range(iters):
            ap = self.matvec(p)
            alpha = rs / torch.dot(p, ap)
            x += alpha * p
            r -= alpha * ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
        return x
