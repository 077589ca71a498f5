"""Kernels B2, B4 and B3 (one-sided BELL2 stream, its accumulating form,
grouped unpermute): the port's plain twins against the reference's
Pallas kernels (interpret mode) on real plan streams.

The streams cover contiguous depth-8, deep depth-16 and depth-32 window
ranges, a listed-window (unit pipeline) plan, a degree-grouped far stream
and sparse accumulating streams. Each reference plan goes through the
port's ``to_device`` as it is (the fields are the same), and the
reference kernels run with exactly the arguments its ``bell2_apply``
passes (word/nibble forms included).

The B2 output buffer is NaN-poisoned: on the card, blocks a stream never
visits hold whatever the buffer held, and the interpreter's zero fill
would hide a sentinel bug. Visited blocks must come out finite, and after
the unpermute absent rows must read exact 0.

Tolerances: ``allclose_spmv`` at float32 with the backward-error scale
(|vals| |x| through the float64 twin) for B2/B4, whose summation order
differs; B3 is a pure gather and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from cfs_spmv_tpu.formats.bell2 import build_bell2_plan
from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.formats.sbell import build_sbell_plan
from cfs_spmv_tpu.ops import bell2_kernel as ref_bk
from cfs_spmv_tpu.ops import spmv as ref_ops
from cfs_spmv_tpu.utils import proxies
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

torch.set_num_threads(1)


def _general(gen, **kw):
    return lambda: build_bell2_plan(gen(), **kw)


def _band(hb, **kw):
    return _general(
        lambda: proxies.random_band(n=4000, per_row=10, half_bw=hb), **kw
    )


def _listed():
    csr = proxies.cant_proxy(n=2048, half_bw=8)
    return build_bell2_plan(
        RefCSR.from_coo(csr.to_coo().expand_symmetric())
    )


def _audikw_far():
    return build_sbell_plan(proxies.audikw_proxy(nb=1000)).far


def _grouped_empty_rows():
    """Scattered rows, half of them empty, a few dense: degree grouping
    triggers and the empty rows unpermute through the zero sentinel
    (the generator of ``test_degree_group.test_grouped_with_empty_rows``)."""
    rng = np.random.default_rng(2)
    n = 2000
    deg = np.zeros(n, np.int64)
    live = rng.choice(n, n // 2, replace=False)
    deg[live] = rng.integers(1, 6, len(live))
    deg[live[:4]] = 300
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    col = rng.integers(0, n, len(row)).astype(np.int64)
    val = rng.uniform(-1, 1, len(row))
    return build_bell2_plan(
        RefCSR.from_coo(RefCOO(n, n, row, col, val).canonicalize())
    )


def _flagship_far():
    return build_sbell_plan(__graft_entry__._flagship()).far


def _band_with_holes():
    """Depth-16 sparse stream over 8-tile blocks whose rows 1024-3071
    are empty, so two of its four output blocks are never visited."""
    coo = proxies.random_band(n=4000, per_row=10, half_bw=1000).to_coo()
    keep = (coo.row < 1024) | (coo.row >= 3072)
    csr = RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                 coo.col[keep], coo.val[keep]))
    return build_bell2_plan(csr, tiles_per_block=8, cover_all_tiles=False)


#: name -> (plan factory, window depth, contig, grouped, the case must
#: have absent rows (dense) / unvisited blocks (sparse))
DENSE = {
    "contig8": (_band(300), 8, True, False, False),
    "deep16": (_band(1000), 16, True, False, False),
    "deep32": (_band(2000), 32, True, False, False),
    "listed": (_listed, 8, False, False, False),
    "grouped": (_audikw_far, 8, True, True, False),
    "grouped_empty_rows": (_grouped_empty_rows, 16, True, True, True),
}
SPARSE = {
    "flagship_far": (_flagship_far, 8, True, False, False),
    "deep16_holes": (_band_with_holes, 16, True, False, True),
}


def _x2d(plan, seed):
    x = np.random.default_rng(seed).uniform(10.01, 20.42, plan.ncols)
    return x.astype(np.float32)


def _ref_kw(rd):
    """The arguments the reference's apply layer passes its kernels."""
    return dict(
        num_row_tiles=rd.num_row_tiles, chunks_per_step=rd.chunks_per_step,
        tiles_per_block=rd.tiles_per_block, interpret=True, run=rd.run_len,
        wmax=rd.max_windows, contig=rd.windows_contig,
        depth=rd.window_depth, rot=rd.lane_rot, nib=rd.nib,
    )


def _port_kw(pd):
    return dict(num_row_tiles=pd.num_row_tiles,
                chunks_per_step=pd.chunks_per_step,
                tiles_per_block=pd.tiles_per_block, contig=pd.contig)


def _visited_rows(pd):
    BT = pd.tiles_per_block
    blocks = np.unique(pd.step_block.numpy())
    rows = (blocks[:, None] * BT + np.arange(BT)[None, :]).ravel()
    return rows[rows < pd.num_row_tiles]


def _check_plan(plan, depth, contig, grouped, sparse):
    assert plan.window_depth == depth
    assert plan.windows_contig == contig
    assert (plan.row_perm is not None) == grouped
    assert plan.sparse_stream == sparse or grouped


@pytest.mark.parametrize("name", sorted(DENSE))
def test_bell2_spmv_plain_matches_reference(name):
    make, depth, contig, grouped, holes = DENSE[name]
    plan = make()
    _check_plan(plan, depth, contig, grouped, False)
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    x = _x2d(plan, 1)
    x2d_np = np.asarray(ref_ops.pad_x(jnp.asarray(x), plan.x_rows))
    ref = np.asarray(ref_bk.bell2_spmv_tiles(
        rd.vals, rd.packed, rd.meta, rd.step_block, jnp.asarray(x2d_np),
        segs=rd.word_segs, **_ref_kw(rd),
    ))
    kw = _port_kw(pd)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    poison = torch.full((TP, 128), float("nan"))
    x2d = torch.from_numpy(x2d_np.copy())
    got = bk.bell2_spmv_tiles(pd.vals, pd.packed, pd.meta, pd.step_block,
                              x2d, out=poison, **kw)
    scale = bk.bell2_spmv_tiles_plain(
        pd.vals.abs().double(), pd.packed, pd.meta, pd.step_block,
        x2d.abs().double(), **kw,
    )
    rows = _visited_rows(pd)
    if not grouped:
        assert len(rows) == pd.num_row_tiles  # dense streams visit all
    got_v = got.numpy()[rows]
    assert np.isfinite(got_v).all()
    assert allclose_spmv(got_v, ref[rows], np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy()[rows])
    if grouped:
        # unpermute the poisoned output: absent rows (and rows of
        # unvisited blocks) read exact 0, live rows match the reference
        y = ops._unperm_tiles(pd, got).reshape(-1)[: plan.nrows].numpy()
        y_ref = np.asarray(
            ref_ops._unperm_tiles(rd, jnp.asarray(ref))
        ).reshape(-1)[: plan.nrows]
        absent = plan.row_perm == plan.num_row_tiles * 128
        assert absent.any() == holes
        assert np.all(y[absent] == 0.0)
        assert np.isfinite(y).all()
        ys = ops._unperm_tiles(pd, scale.float()).reshape(-1)
        assert allclose_spmv(y, y_ref, np.float32,
                             nnz_per_row=plan.nnz / plan.nrows,
                             scale=ys.numpy()[: plan.nrows])


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_bell2_spmv_accum_plain_matches_reference(name):
    make, depth, contig, grouped, holes = SPARSE[name]
    plan = make()
    _check_plan(plan, depth, contig, grouped, True)
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    x = _x2d(plan, 2)
    x2d_np = np.asarray(ref_ops.pad_x(jnp.asarray(x), plan.x_rows))
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    y0 = np.random.default_rng(3).uniform(-1, 1, (TP, 128)).astype(
        np.float32
    )
    ref = np.asarray(ref_bk.bell2_spmv_tiles_accum(
        rd.vals, rd.packed, rd.meta, rd.step_block, jnp.asarray(x2d_np),
        jnp.asarray(y0), **_ref_kw(rd),
    ))
    kw = _port_kw(pd)
    x2d = torch.from_numpy(x2d_np.copy())
    y = torch.from_numpy(y0.copy())
    got = bk.bell2_spmv_tiles_accum(pd.vals, pd.packed, pd.meta,
                                    pd.step_block, x2d, y, **kw)
    assert got.data_ptr() == y.data_ptr()  # accumulated in place
    scale = bk.bell2_spmv_tiles_accum_plain(
        pd.vals.abs().double(), pd.packed, pd.meta, pd.step_block,
        x2d.abs().double(), torch.from_numpy(np.abs(y0)).double(), **kw,
    )
    assert allclose_spmv(got.numpy(), ref, np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy())
    # blocks without chunks keep the incoming values exactly
    untouched = np.setdiff1d(np.arange(TP), _visited_rows(pd))
    assert (len(untouched) > 0) == holes
    assert np.array_equal(got.numpy()[untouched], y0[untouched])


def test_unperm_gather_plain_matches_reference_exactly():
    plan = _audikw_far()
    pd = ops.to_device(plan, "cpu")
    W = plan.unperm_slabs.shape[1]
    g = np.random.default_rng(4).uniform(
        -1, 1, (plan.num_row_tiles, 128)
    ).astype(np.float32)
    ref = np.asarray(ref_bk.unperm_gather_tiles(
        jnp.asarray(plan.unperm_pk), jnp.asarray(plan.unperm_slabs),
        jnp.asarray(g), W=W, interpret=True,
    ))
    got = bk.unperm_gather_tiles(pd.unperm_pk, pd.unperm_slabs,
                                 torch.from_numpy(g))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert np.all(got.numpy().reshape(-1)[plan.unperm_pk.reshape(-1) < 0]
                  == 0.0)


def test_bell2_wrappers_check_operands():
    plan = _band(300)()
    pd = ops.to_device(plan, "cpu")
    x2d = torch.zeros((plan.x_rows, 128))
    kw = _port_kw(pd)
    with pytest.raises(ValueError):  # packed must stay int16
        bk.bell2_spmv_tiles(pd.vals, pd.packed.int(), pd.meta,
                            pd.step_block, x2d, **kw)
    with pytest.raises(ValueError):  # wrong output buffer shape
        bk.bell2_spmv_tiles(pd.vals, pd.packed, pd.meta, pd.step_block,
                            x2d, out=torch.empty((1, 128)), **kw)
    with pytest.raises(ValueError):  # chunk count not a K multiple
        bk.bell2_spmv_tiles(pd.vals[:-8], pd.packed[:-8], pd.meta[:-1],
                            pd.step_block, x2d, **kw)
    assert bk.bell2_spmv_tiles.launches == 0
    assert bk.bell2_spmv_tiles_accum.launches == 0
    assert bk.unperm_gather_tiles.launches == 0
