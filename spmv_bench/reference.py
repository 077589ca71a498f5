"""The plain reference: the full symmetric product and a fixed-iteration
CG, in float64, with plain PyTorch operations on the benchmark's own
lower-triangle CSR. It imports nothing of the program and takes nothing
the program made: the program's outputs are only judged against it."""

from __future__ import annotations

import warnings

import numpy as np
import torch


class Reference:
    """``y = A x`` of the symmetric matrix whose lower triangle (the
    diagonal included) is ``mat``, on ``device``: the whole matrix, each
    entry off the diagonal mirrored, as a PyTorch CSR tensor in float64,
    and |A| beside it on the same indices."""

    def __init__(self, mat, device):
        n = mat.n
        col = torch.as_tensor(mat.indices, device=device).long()
        row = torch.repeat_interleave(
            torch.arange(n, device=device),
            torch.as_tensor(np.diff(mat.indptr), device=device))
        val = torch.as_tensor(mat.data, device=device, dtype=torch.float64)
        off = row != col
        ij = torch.stack([torch.cat([row, col[off]]),
                          torch.cat([col, row[off]])])
        vals = torch.cat([val, val[off]])
        del row, col, val, off
        with warnings.catch_warnings():  # PyTorch calls CSR "beta"
            warnings.simplefilter("ignore", UserWarning)
            self.a = torch.sparse_coo_tensor(ij, vals, (n, n)).coalesce() \
                .to_sparse_csr()
            del ij, vals
            self.abs_a = torch.sparse_csr_tensor(
                self.a.crow_indices(), self.a.col_indices(),
                self.a.values().abs(), (n, n))
        self.n = n

    def matvec(self, x: torch.Tensor, absolute: bool = False):
        """A x, or |A| |x| with ``absolute``, in float64; x (n,) or
        (n, B)."""
        x = x.to(torch.float64)
        if absolute:
            return self.abs_a @ x.abs()
        return self.a @ x

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


def apply_error(y: torch.Tensor, y_ref: torch.Tensor,
                scale: torch.Tensor) -> float:
    """The largest difference of ``y`` from ``y_ref``, each entry scaled by
    its row's |A| |x|: the backward-error measure of a product in finite
    precision. A NaN or an infinity reads as infinity."""
    d = (y.to(torch.float64) - y_ref).abs()
    d = torch.where(scale > 0, d / scale, d)
    return _largest(d)


def solve_error(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """||x - x_ref|| / ||x_ref||; a NaN or an infinity reads as infinity."""
    d = torch.linalg.vector_norm(x.to(torch.float64) - x_ref)
    return _largest(d / torch.linalg.vector_norm(x_ref))


def _largest(t: torch.Tensor) -> float:
    v = float(t.max())
    return v if np.isfinite(v) else float("inf")
