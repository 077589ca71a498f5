"""Synthetic proxy-matrix generators for the BASELINE workloads.

The reference benches real SuiteSparse files passed on argv
(``bench/bench_spmv_mmf.cpp:145-148``); none are vendored (SURVEY §4)
and this environment has no network, so the harnesses generate
structure-matched proxies at the BASELINE matrices' scales instead:

- ``cant_proxy``     — symmetric banded FEM (config 2); at
  ``n=4_147_110, half_bw=40`` it is the Queen_4147-scale stand-in
  (4.15M rows, ~332M logical nnz, banded).
- ``stencil27``      — 3D 27-point stencil; ``g=203`` is the
  nlpkkt160-scale stand-in (8.37M rows, ~225M logical nnz).
- ``audikw_proxy``   — 3x3 dense blocks at random small offsets
  (RCM-resistant scattered structure); ``nb=314565`` is the
  audikw_1-scale stand-in (943,695 rows, ~78.5M logical nnz).
- ``general_asym``   — structurally symmetric, numerically asymmetric
  3D convection-diffusion stencil (the general-path workload).
- ``random_band``    — adversarial: random columns in a wide band, no
  exploitable diagonal/block structure.

Shared by ``bench.py`` (repo root) and ``cli/bench_dist.py --gen``.
"""

from __future__ import annotations

import numpy as np

from ..formats.coo import COO
from ..formats.csr import CSR

__all__ = [
    "cant_proxy",
    "stencil27",
    "audikw_proxy",
    "general_asym",
    "near_band_paired",
    "random_band",
    "GENERATORS",
]


def cant_proxy(n=62464, half_bw=32, dtype=np.float32, seed=0) -> CSR:
    """Symmetric banded FEM-proxy: each row's lower triangle is the
    contiguous band [i-half_bw, i); uniform degree like `cant`."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows)).astype(dtype)
    diag = np.arange(n, dtype=np.int64)
    r = np.concatenate([rows, diag])
    c = np.concatenate([cols, diag])
    v = np.concatenate([vals, rng.uniform(1.0, 2.0, n).astype(dtype)])
    coo = COO(n, n, r, c, v, symmetric=True).canonicalize()
    return CSR.from_coo(coo)


def stencil27(g=40, dtype=np.float32, seed=0) -> CSR:
    """3D 27-point stencil lower triangle (nlpkkt-like clustering)."""
    idx = np.arange(g**3).reshape(g, g, g)
    rows_l, cols_l = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if (dz, dy, dx) < (0, 0, 0):
                    continue
                src = idx[
                    max(0, dz) : g + min(0, dz) or g,
                    max(0, dy) : g + min(0, dy) or g,
                    max(0, dx) : g + min(0, dx) or g,
                ]
                dst = idx[
                    max(0, -dz) : g + min(0, -dz) or g,
                    max(0, -dy) : g + min(0, -dy) or g,
                    max(0, -dx) : g + min(0, -dx) or g,
                ]
                rows_l.append(src.ravel())
                cols_l.append(dst.ravel())
    row = np.concatenate(rows_l)
    col = np.concatenate(cols_l)
    swap = col > row
    row[swap], col[swap] = col[swap], row[swap].copy()
    v = np.random.default_rng(seed).uniform(0.5, 1.5, len(row)).astype(dtype)
    coo = COO(
        g**3, g**3, row.astype(np.int64), col.astype(np.int64), v,
        symmetric=True,
    ).canonicalize()
    return CSR.from_coo(coo)


def audikw_proxy(nb=30000, b=3, nbr=14, seed=0) -> CSR:
    """audikw-class proxy: 3x3 dense blocks at random offsets within 300
    block rows — RCM-resistant scattered structure whose entries land
    almost entirely on the one-sided far stream (the hard shape)."""
    rng = np.random.default_rng(seed)
    br = np.repeat(np.arange(nb, dtype=np.int64), nbr)
    off = rng.integers(1, 300, nb * nbr)
    bc = np.maximum(br - off, 0)
    ri, ci = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    row = (br[:, None] * b + ri.ravel()[None, :]).ravel()
    col = (bc[:, None] * b + ci.ravel()[None, :]).ravel()
    val = rng.uniform(-1, 1, len(row))
    keep = row > col
    row, col, val = row[keep], col[keep], val[keep]
    n = nb * b
    diag = np.arange(n, dtype=np.int64)
    row = np.concatenate([row, diag])
    col = np.concatenate([col, diag])
    val = np.concatenate([val, rng.uniform(1, 2, n)])
    return CSR.from_coo(
        COO(n, n, row, col, val.astype(np.float32), symmetric=True)
        .canonicalize()
    )


def general_asym(g=80, seed=0) -> CSR:
    """General ASYMMETRIC 3D convection-diffusion proxy: 7-point stencil
    pattern with upwind-biased (non-symmetric) coefficients."""
    rng = np.random.default_rng(seed)
    n = g**3
    idx = np.arange(n).reshape(g, g, g)
    rows_l, cols_l = [idx.ravel()], [idx.ravel()]
    for axis, d in ((2, 1), (1, g), (0, g * g)):
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        src[axis] = slice(1, None)
        dst[axis] = slice(0, -1)
        rows_l += [idx[tuple(src)].ravel(), idx[tuple(dst)].ravel()]
        cols_l += [idx[tuple(dst)].ravel(), idx[tuple(src)].ravel()]
    row = np.concatenate(rows_l)
    col = np.concatenate(cols_l)
    # upwind bias: downstream couplings stronger than upstream — the
    # matrix is structurally symmetric but numerically asymmetric
    val = np.where(
        row > col,
        rng.uniform(-1.5, -0.5, len(row)),
        rng.uniform(-0.5, -0.1, len(row)),
    )
    val[row == col] = 6.5
    coo = COO(n, n, row.astype(np.int64), col.astype(np.int64),
              val.astype(np.float32))
    return CSR.from_coo(coo.canonicalize())


def near_band_paired(n=50_000, n_diags=96, max_off=800, p_active=0.3,
                     fill=0.55, seed=0) -> CSR:
    """Near-banded irregular symmetric proxy: exact diagonals that are
    LOCALLY dense (per-tile fill ~``fill`` on a ``p_active`` fraction of
    row tiles) but globally below the SDIA density bar
    (``p_active * fill`` < SDIA_FILL), so the entries land on the PAIRED
    SBELL stream — the direct realization of the reference's symmetric
    pairing (``csr_matrix.tpp:3001-3015``) that the SDIA-dominated bench
    shapes never exercise (VERDICT r4 missing #2)."""
    rng = np.random.default_rng(seed)
    T = -(-n // 128)
    offs = np.sort(rng.choice(np.arange(1, max_off), n_diags,
                              replace=False))
    rows_l, cols_l = [], []
    lanes = np.arange(128, dtype=np.int64)
    for d in offs:
        active = np.flatnonzero(rng.uniform(size=T) < p_active)
        if not len(active):
            continue
        rows = (active[:, None] * 128 + lanes[None, :]).ravel()
        keep = (rng.uniform(size=len(rows)) < fill) & (rows >= d) & (
            rows < n
        )
        rows = rows[keep]
        rows_l.append(rows)
        cols_l.append(rows - d)
    z = [np.zeros(0, np.int64)]  # all diagonals may draw no active tile
    row = np.concatenate(rows_l or z)
    col = np.concatenate(cols_l or z)
    val = rng.uniform(-1, 1, len(row)).astype(np.float32)
    diag = np.arange(n, dtype=np.int64)
    row = np.concatenate([row, diag])
    col = np.concatenate([col, diag])
    val = np.concatenate([val, rng.uniform(1, 2, n).astype(np.float32)])
    coo = COO(n, n, row, col, val, symmetric=True).canonicalize()
    return CSR.from_coo(coo)


def random_band(n=50_000, per_row=28, half_bw=1500, seed=0) -> CSR:
    """Adversarial: ~per_row RANDOM columns within a 2*half_bw-wide
    band, asymmetric — no exploitable structure at all."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    col = row + rng.integers(-half_bw, half_bw + 1, n * per_row)
    np.clip(col, 0, n - 1, out=col)
    val = rng.uniform(-1, 1, len(row)).astype(np.float32)
    coo = COO(n, n, row, col, val)
    return CSR.from_coo(coo.canonicalize())


#: ``--gen`` names -> (generator, full-scale kwargs) for the BASELINE
#: matrices' scales
GENERATORS = {
    "cant": (cant_proxy, {}),
    "queen": (cant_proxy, dict(n=4_147_110, half_bw=40)),
    "nlpkkt": (stencil27, dict(g=203)),
    "audikw": (audikw_proxy, dict(nb=314565)),
    "audikw_proxy": (audikw_proxy, {}),
    "general": (general_asym, {}),
    "paired": (near_band_paired, {}),
    "band": (random_band, {}),
    # small variant for tests / interpreter smoke runs
    "band_small": (random_band, dict(n=4000, per_row=10, half_bw=300)),
}
