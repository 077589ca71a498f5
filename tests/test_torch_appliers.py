"""The appliers where the port's fused and store forms run, against the
reference's appliers on the same plans and against the float64 oracle.

``sbell_apply(_mm)`` hands the seed ``D x`` to the unpermute of a grouped
far stream (B3/B9's ``seed`` form, X read in place) or adds the gather
into the paired stream's tiles (``into``); mirrored diagonals and a
general plan's peel read X interleaved, in place where it is one group
already (``sdia_kernel.gen_x``); a dia-only general plan has B6/B12 write
its tiles (the store form, from x itself). Each plan is the reference's,
uploaded as it is; the reference's appliers run in Pallas interpret mode
at one right-hand side and at B = 2 (the multi-RHS interpreter is slow;
the paired plan at one), the port's also at B = 3 and 8 against the
oracle, its kernel wrappers' CPU forms bit for bit the plain twins'.

Tolerance: ``allclose_spmv`` at float32 with the backward-error scale
``|A| |x|``, column by column, since the reference, the twins and the
card sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfs_spmv_tpu as ref_cfs
from cfs_spmv_tpu.formats import sdia as ref_sdia
from cfs_spmv_tpu.formats.bell2 import build_general_plan as ref_general
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_build
from cfs_spmv_tpu.ops import spmv as ref_ops
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.formats import sdia as port_sdia
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

from conftest import random_x

torch.set_num_threads(1)


def _paired_with_grouped_far():
    """``near_band_paired`` plus an audikw-like scattered part: under
    ``CFS_PAIRED=force`` its plan has a paired stream and a grouped far
    stream (the unpermute adds into the paired stream's tiles)."""
    n = 2000
    base = ref_proxies.near_band_paired(n=n, n_diags=16, max_off=200,
                                        seed=5).to_coo()
    far = ref_proxies.audikw_proxy(nb=667).to_coo()
    keep = (far.row < n) & (far.col < n)
    return ref_cfs.CSR.from_coo(ref_cfs.COO(
        n, n, np.concatenate([base.row, far.row[keep]]),
        np.concatenate([base.col, far.col[keep]]),
        np.concatenate([base.val, far.val[keep]]),
        symmetric=True).canonicalize())


def _grouped_general():
    """A general plan whose stream is degree-grouped (half the rows
    empty), with no diagonal peel."""
    rng = np.random.default_rng(2)
    n = 2000
    deg = np.zeros(n, np.int64)
    live = rng.choice(n, n // 2, replace=False)
    deg[live] = rng.integers(1, 6, len(live))
    deg[live[:4]] = 300
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    col = rng.integers(0, n, len(row)).astype(np.int64)
    return ref_cfs.CSR.from_coo(ref_cfs.COO(
        n, n, row, col, rng.uniform(-1, 1, len(row))).canonicalize())


#: name -> (reference CSR, plan builder, CFS_PAIRED, mirrored diagonals);
#: the comment says what the port's applier runs
PLANS = {
    # the unpermute's seed form
    "grouped_far": (lambda: ref_proxies.audikw_proxy(nb=1000), ref_build,
                    None, False),
    # the unpermute's into form
    "paired_grouped_far": (_paired_with_grouped_far, ref_build, "force",
                           False),
    # B6/B12 adding, X in place or copied
    "mirrored": (lambda: ref_proxies.cant_proxy(n=4096), ref_build, None,
                 True),
    # B6/B12 storing, from x unpadded and X in place or copied
    "dia_only": (lambda: ref_proxies.general_asym(g=12), ref_general, None,
                 False),
    # the unpermute's gather
    "grouped_general": (_grouped_general, ref_general, None, False),
}

WRAPPERS = (sk.sdia_sym_tiles, sk.sdia_gen_tiles, bk.bell2_spmv_tiles,
            bk.bell2_spmv_tiles_accum, bk.unperm_gather_tiles,
            bk.sbell_spmv_tiles, sk.sdia_sym_tiles_mm, sk.sdia_gen_tiles_mm,
            bk.bell2_spmm_tiles, bk.bell2_spmm_tiles_accum,
            bk.unperm_gather_tiles_mm, bk.sbell_spmm_tiles)


def _close(y, y_ref, csr, x, nnz):
    assert allclose_spmv(y, y_ref, np.float32, nnz_per_row=nnz / csr.nrows,
                         scale=csr.spmv_host(x.astype(np.float64),
                                             absolute=True))


@pytest.mark.parametrize("B", [None, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_fused_appliers_match_reference_appliers(name, B, monkeypatch):
    """SpMV (``None``) and SpMM at B = 2 against the reference's applier
    on the same plan and against the oracle; at B = 3 (X copied for the
    diagonals) and 8 (X in place) against the oracle; the plain path bit
    for bit."""
    gen, build, paired, mirrored = PLANS[name]
    if paired:
        monkeypatch.setenv("CFS_PAIRED", paired)
    if mirrored:  # mirror the symmetric diagonals at test size
        monkeypatch.setattr(ref_sdia, "SDIA_SYM_ROWS_MAX", 100)
        monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)
    csr = gen()
    plan = build(csr)
    sym = build is ref_build
    dev = (ops.sym_to_device if sym else ops.to_device)(plan, "cpu")
    rdev = (ref_ops.sym_to_device if sym else ref_ops.to_device)(plan)
    kind = {
        "grouped_far": sym and dev.far is not None and dev.far.grouped
        and not dev.has_paired,
        "paired_grouped_far": sym and dev.far is not None and dev.far.grouped
        and dev.has_paired,
        "mirrored": sym and dev.dia_mirrored and dev.far is None,
        "dia_only": not sym and not dev.has_work
        and dev.dia_vals is not None,
        "grouped_general": not sym and dev.grouped and dev.dia_vals is None,
    }
    assert kind[name]
    nnz = csr.nnz * (2 if csr.symmetric else 1)
    X = random_x(csr.ncols * (B or 1), np.float32).reshape(-1, B or 1)
    if B is None:
        apply = ops.sbell_apply if sym else ops.bell2_apply
        ref_apply = ref_ops.sbell_apply if sym else ref_ops.bell2_apply
        xin = X[:, 0]
    else:
        apply = ops.sbell_apply_mm if sym else ops.bell2_apply_mm
        ref_apply = ref_ops.sbell_apply_mm if sym else ref_ops.bell2_apply_mm
        xin = X
    Y = apply(dev, torch.from_numpy(xin).clone())
    assert torch.equal(apply(dev, torch.from_numpy(xin), plain=True), Y)
    Y = Y.numpy().reshape(csr.nrows, -1)
    # the reference's multi-RHS interpreter is slow: its applier runs at
    # one right-hand side and at two (the paired plan: at one)
    with_ref = B is None or (B == 2 and name != "paired_grouped_far")
    Y_ref = (np.asarray(ref_apply(rdev, jnp.asarray(xin))).reshape(
        csr.nrows, -1) if with_ref else None)
    for b in range(B or 1):
        xb = X[:, b]
        _close(Y[:, b], csr.spmv_host(xb.astype(np.float64)), csr, xb, nnz)
        if Y_ref is not None:
            _close(Y[:, b], Y_ref[:, b], csr, xb, nnz)
    for w in WRAPPERS:
        assert w.launches == 0
