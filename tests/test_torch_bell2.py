"""Kernels B2, B4, B3 and B5 (one-sided BELL2 stream, its accumulating
form, grouped unpermute, paired symmetric stream) and their multi-RHS
forms B7, B8, B9 and B10: the port's plain twins against the reference's
Pallas kernels (interpret mode) on real plan streams, and each MM twin
against its SpMV twin column by column.

The streams cover contiguous depth-8, deep depth-16 and depth-32 window
ranges, a listed-window (unit pipeline) plan, a degree-grouped far stream
and sparse accumulating streams. Each reference plan goes through the
port's ``to_device`` as it is (the fields are the same), and the
reference kernels run with exactly the arguments its ``bell2_apply``
passes (word/nibble forms included).

B4 and B8 read the accumulating stream as its live entries
(``compact_stream`` of the reference plan's chunk grid, built by
``to_device``): the entry list is held against an independent decoding of
the grid and against the matrix the plan was built from, the twins against
the reference's kernels on the same plan and against the chunk-grid twin,
and every row no entry names must keep the incoming y bit for bit, NaN
included.

The B2 output buffer is NaN-poisoned: on the card, blocks a stream never
visits hold whatever the buffer held, and the interpreter's zero fill
would hide a sentinel bug. Visited blocks must come out finite, and after
the unpermute absent rows must read exact 0.

The B5 streams are paired plans built with pairing forced
(``CFS_PAIRED=force``), with two and with four transpose windows; their
output buffer is NaN-poisoned too, and every tile must come out finite.

The MM streams run on plans with 8-tile output blocks, so that they have
several blocks (test-sized plans otherwise have one): B7 on contiguous,
listed and deep windows into NaN-poisoned planes, B8 onto planes whose
unvisited blocks hold NaN and must keep it, B9 bit-exact with absent rows
(``pk < 0``) reading exact 0, B10 with two and four transpose windows in
one and in four output blocks.

B3/B9's fused forms (``seed``: the pad of ``diag * x`` plus the padded
gather; ``into``: the padded gather added into given tiles) must equal the
reference's gather followed by those ops bit for bit (``torch.equal``),
on the audikw far stream and a degree-grouped plan over 8-tile blocks with
an absent row range, SpMV and at B = 1, 3, 8, X at strides of its own.

The walks of the CUDA kernels are modelled in numpy against the twins in
float64: B5's (1-4 chunks a CTA, window sums handed over) and B2's (any
chunks a walk, 8 walks a CTA whose first and last rows the CTA adds up in
order, float32 and bf16 values).

Tolerances: ``allclose_spmv`` at float32 with the backward-error scale
(|vals| |x| through the float64 twin) for B2/B4/B5, whose summation order
differs; B3 is a pure gather and must match exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import __graft_entry__
from cfs_spmv_tpu.formats.bell2 import build_bell2_plan
from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.formats.sbell import build_sbell_plan
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_sbell_plan
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


def _listed(**kw):
    csr = proxies.cant_proxy(n=2048, half_bw=8)
    return build_bell2_plan(
        RefCSR.from_coo(csr.to_coo().expand_symmetric()), **kw
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


def _holes_csr():
    coo = proxies.random_band(n=4000, per_row=10, half_bw=1000).to_coo()
    keep = (coo.row < 1024) | (coo.row >= 3072)
    return RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                  coo.col[keep], coo.val[keep]))


def _band_with_holes():
    """Depth-16 sparse stream over 8-tile blocks whose rows 1024-3071
    are empty, so two of its four output blocks are never visited."""
    return build_bell2_plan(_holes_csr(), tiles_per_block=8,
                            cover_all_tiles=False)


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
    blocks = np.unique(np.asarray(pd.step_block))
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


def _grid(plan):
    """The plan's chunk grid as CPU tensors, for the chunk-grid twins."""
    return tuple(torch.from_numpy(np.ascontiguousarray(getattr(plan, k)))
                 for k in ("vals", "packed", "meta", "step_block"))


def _decode_grid(plan):
    """(rows, cols, vals) of every nonzero slot of the plan's chunk grid,
    in grid order, decoded slot by slot from the format's definition
    (independent of ``compact_stream``)."""
    C = plan.meta.shape[0]
    K, BT = plan.chunks_per_step, plan.tiles_per_block
    contig = plan.windows_contig or plan.window_depth > 8
    vals = np.asarray(plan.vals).reshape(C, 8, 128)
    pk = np.asarray(plan.packed).reshape(C, 8, 128).astype(np.int64)
    out = []
    for c, i, lane in zip(*np.nonzero(vals)):
        q = pk[c, i, lane] & 0x7F
        r2 = (pk[c, i, q] >> 7) & 0x1F
        xrow = (plan.meta[c, 2] + r2 if contig
                else plan.meta[c, 2 + (r2 & 7)])
        tile = int(plan.step_block[c // K]) * BT + plan.meta[c, 0]
        out.append((tile * 128 + lane, xrow * 128 + q, vals[c, i, lane]))
    r, c, v = (np.array(a) for a in zip(*out))
    return r.astype(np.int64), c.astype(np.int64), v


def _expanded_cant():
    csr = proxies.cant_proxy(n=2048, half_bw=8)
    return RefCSR.from_coo(csr.to_coo().expand_symmetric())


#: name -> (source CSR factory or None, plan factory, contig, the stream
#: must leave whole output blocks unvisited)
COMPACT = {
    "contig8": (lambda: proxies.random_band(n=4000, per_row=10, half_bw=300),
                lambda csr: build_bell2_plan(csr), True, False),
    "deep16_bt8": (
        lambda: proxies.random_band(n=4000, per_row=10, half_bw=1000),
        lambda csr: build_bell2_plan(csr, tiles_per_block=8), True, False),
    "listed_bt8": (_expanded_cant,
                   lambda csr: build_bell2_plan(csr, tiles_per_block=8),
                   False, False),
    "deep16_holes": (_holes_csr,
                     lambda csr: build_bell2_plan(csr, tiles_per_block=8,
                                                  cover_all_tiles=False),
                     True, True),
    "flagship_far": (None, lambda csr: _flagship_far(), True, False),
}


@pytest.mark.parametrize("name", sorted(COMPACT))
def test_compact_stream_matches_grid_and_matrix(name):
    """The entry list of contiguous, deep and listed windows, 8-tile
    blocks, K-padding chunks and an absent row range: as many entries as
    the grid has nonzero slots, rows ascending, and as a matrix equal to
    the slot-by-slot decoding and to the CSR the plan was built from."""
    make_csr, make_plan, contig, holes = COMPACT[name]
    csr = make_csr() if make_csr else None
    plan = make_plan(csr)
    assert (plan.windows_contig or plan.window_depth > 8) == contig
    kw = dict(chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block, contig=contig,
              num_row_tiles=plan.num_row_tiles, x_rows=plan.x_rows)
    es = bk.compact_stream(plan.vals, plan.packed, plan.meta,
                           plan.step_block, **kw)
    assert es.count == np.count_nonzero(plan.vals) == plan.nnz
    assert es.rows.dtype == es.cols.dtype == torch.int32
    assert es.vals.dtype == torch.float32
    rows, cols = es.rows.numpy().astype(np.int64), es.cols.numpy()
    assert np.all(np.diff(rows) >= 0)
    assert es.min_tiles == rows[-1] // 128 + 1 <= plan.num_row_tiles
    assert es.min_x_rows == cols.max() // 128 + 1 <= plan.x_rows
    # the grid holds padding: whole K-padding chunks, and empty slots
    C = plan.meta.shape[0]
    live_chunks = np.unique(np.nonzero(
        np.asarray(plan.vals).reshape(C, -1))[0])
    if name in ("flagship_far", "deep16_holes"):
        assert len(live_chunks) < C
    assert es.count < plan.vals.size
    shape = (plan.num_row_tiles * 128, plan.x_rows * 128)
    got = sp.coo_matrix((es.vals.numpy(), (rows, cols)), shape=shape).tocsr()
    dr, dc, dv = _decode_grid(plan)
    # stable sort: within a row the grid's order is kept
    order = np.argsort(dr, kind="stable")
    assert np.array_equal(rows, dr[order])
    assert np.array_equal(cols, dc[order])
    assert np.array_equal(es.vals.numpy(), dv[order])
    if csr is not None:
        want = sp.csr_matrix(
            (csr.data.astype(np.float32), csr.indices, csr.indptr),
            shape=(csr.nrows, csr.ncols))
        want.resize(shape)
        assert (got != want).nnz == 0
        untouched = np.setdiff1d(np.arange(shape[0]), rows)
        assert (len(untouched) >= 2048) == holes
    # the kernel reads without bounds checks: indices outside y or x raise
    with pytest.raises(ValueError, match="row"):
        bk.compact_stream(plan.vals, plan.packed, plan.meta, plan.step_block,
                          **{**kw, "num_row_tiles": es.min_tiles - 1})
    with pytest.raises(ValueError, match="column"):
        bk.compact_stream(plan.vals, plan.packed, plan.meta, plan.step_block,
                          **{**kw, "x_rows": es.min_x_rows - 1})


def _abs64(es):
    """The entries with |vals| in float64, for the error scale."""
    return dataclasses.replace(es, vals=es.vals.abs().double())


def _untouched_mask(es, tiles):
    """Flat mask over (tiles, 128) of the rows no entry names."""
    mask = np.ones(tiles * 128, bool)
    mask[es.rows.numpy()] = False
    return mask


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_bell2_spmv_accum_plain_matches_reference(name):
    make, depth, contig, grouped, holes = SPARSE[name]
    plan = make()
    _check_plan(plan, depth, contig, grouped, True)
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    es = pd.entries
    assert pd.vals is None and pd.packed is None  # the grid is not uploaded
    assert es.count == plan.nnz
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
    x2d = torch.from_numpy(x2d_np.copy())
    y = torch.from_numpy(y0.copy())
    got = bk.bell2_spmv_tiles_accum(es, x2d, y)
    assert got.data_ptr() == y.data_ptr()  # accumulated in place
    scale = bk.bell2_spmv_tiles_accum_plain(
        _abs64(es), x2d.abs().double(),
        torch.from_numpy(np.abs(y0)).double(),
    )
    assert allclose_spmv(got.numpy(), ref, np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy())
    # the entry form against the chunk-grid twin on the same plan
    grid = bk.bell2_spmv_tiles_plain(
        *_grid(plan), x2d, out=torch.zeros((TP, 128)), **_port_kw(pd))
    assert allclose_spmv(got.numpy()[: pd.num_row_tiles],
                         y0[: pd.num_row_tiles] + grid.numpy(), np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy()[: pd.num_row_tiles])
    # blocks without chunks keep the incoming values exactly
    untouched = np.setdiff1d(np.arange(TP), _visited_rows(plan))
    assert (len(untouched) > 0) == holes
    assert np.array_equal(got.numpy()[untouched], y0[untouched])
    # y needs only the tiles the entries name, and every row no entry
    # names keeps the incoming y bit for bit, NaN included
    mask = _untouched_mask(es, es.min_tiles)
    y1 = y0[: es.min_tiles].copy()
    y1.reshape(-1)[mask] = np.nan
    got1 = bk.bell2_spmv_tiles_accum(es, x2d, torch.from_numpy(y1.copy()))
    assert np.array_equal(got1.numpy().view(np.int32).reshape(-1)[mask],
                          y1.view(np.int32).reshape(-1)[mask])
    assert np.array_equal(got1.numpy().reshape(-1)[~mask],
                          got.numpy()[: es.min_tiles].reshape(-1)[~mask])


def test_entry_form_does_not_spread_nonfinite_x():
    """The documented difference: a NaN in x at an address that only
    padded slots of the chunk grid gather reaches rows of the chunk form
    (0 * NaN) and no row of the entry form."""
    plan = _flagship_far()
    pd = ops.to_device(plan, "cpu")
    es = pd.entries
    vals, packed, meta, step_block = _grid(plan)
    C = meta.shape[0]
    pk = packed.reshape(C, 8, 128).long()
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 0x1F, 2, q)
    addr = (meta[:, 2, None, None].long() + r2) * 128 + q  # contig windows
    padded = addr[vals.reshape(C, 8, 128) == 0].unique()
    live = es.cols.long().unique()
    only_padded = padded[~torch.isin(padded, live)]
    assert len(only_padded) > 0
    x2d = torch.ones((plan.x_rows, 128))
    x2d.view(-1)[only_padded[0]] = float("nan")
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    chunk = bk.bell2_spmv_tiles_plain(vals, packed, meta, step_block, x2d,
                                      out=torch.zeros((TP, 128)),
                                      **_port_kw(pd))
    entry = bk.bell2_spmv_tiles_accum(
        es, x2d, torch.zeros((pd.num_row_tiles, 128)))
    assert torch.isnan(chunk).any()
    assert torch.isfinite(entry).all()


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


@pytest.mark.parametrize("tw,bt", [(2, None), (4, None), (4, 8)])
def test_sbell_spmv_plain_matches_reference(tw, bt, monkeypatch):
    """Forced paired plans with two and four transpose windows, in one
    output block and (``bt=8``) in four."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    csr = proxies.near_band_paired(n=4000, n_diags=32, max_off=300, seed=5)
    plan = ref_sbell_plan(csr, transpose_windows=tw, tiles_per_block=bt)
    assert plan.nnz_paired > 0 and plan.transpose_windows == tw
    assert len(np.unique(plan.step_block)) == (1 if bt is None else 4)
    pd = ops.sym_to_device(plan, "cpu")
    assert pd.has_paired
    x = np.random.default_rng(6).uniform(10.01, 20.42, plan.nrows)
    x2d_np = np.asarray(
        ref_ops.pad_x(jnp.asarray(x.astype(np.float32)), plan.x_rows)
    )
    kw = dict(num_row_tiles=plan.num_row_tiles,
              chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block, transpose_windows=tw)
    ref = np.asarray(ref_bk.sbell_spmv_tiles(
        jnp.asarray(plan.vals), jnp.asarray(plan.packed),
        jnp.asarray(plan.meta), jnp.asarray(plan.step_block),
        jnp.asarray(x2d_np), interpret=True, **kw,
    ))
    x2d = torch.from_numpy(x2d_np.copy())
    TP = -(-plan.num_row_tiles // plan.tiles_per_block) * plan.tiles_per_block
    poison = torch.full((TP, 128), float("nan"))
    got = bk.sbell_spmv_tiles(pd.vals, pd.packed, pd.meta, pd.step_block,
                              x2d, out=poison, **kw)
    assert got.shape == ref.shape and np.isfinite(poison.numpy()).all()
    scale = bk.sbell_spmv_tiles_plain(
        pd.vals.abs().double(), pd.packed, pd.meta, pd.step_block,
        x2d.abs().double(), **kw,
    )
    assert allclose_spmv(got.numpy(), ref, np.float32,
                         nnz_per_row=2 * plan.nnz_paired / plan.nrows,
                         scale=scale.numpy())


#: MM streams with 8-tile output blocks: name -> (plan factory, window
#: depth, contig)
DENSE_MM = {
    "contig8": (_band(300, tiles_per_block=8), 8, True),
    "listed": (lambda: _listed(tiles_per_block=8), 8, False),
    "deep16": (_band(1000, tiles_per_block=8), 16, True),
}


def _x3d(n, x_rows, B, seed):
    """(B, x_rows, 128) planes of random x of length n, padded as the
    appliers pad."""
    X = np.random.default_rng(seed).uniform(10.01, 20.42, (n, B))
    x3d = np.zeros((B, x_rows * 128), np.float32)
    x3d[:, :n] = X.T
    return x3d.reshape(B, x_rows, 128)


@pytest.mark.parametrize("name", sorted(DENSE_MM))
def test_bell2_spmm_plain_matches_reference(name):
    """B7 into NaN-poisoned planes: every block is visited, so every
    tile of every plane comes out finite and matches the reference."""
    make, depth, contig = DENSE_MM[name]
    plan = make()
    _check_plan(plan, depth, contig, False, False)
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    assert len(np.unique(plan.step_block)) > 1
    B = 2
    x3d_np = _x3d(plan.ncols, plan.x_rows, B, 11)
    ref = np.asarray(ref_bk.bell2_spmm_tiles(
        rd.vals, rd.packed, rd.meta, rd.step_block, jnp.asarray(x3d_np),
        segs=rd.word_segs, **_ref_kw(rd),
    ))
    kw = _port_kw(pd)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    poison = torch.full((B, TP, 128), float("nan"))
    x3d = torch.from_numpy(x3d_np)
    got = bk.bell2_spmm_tiles(pd.vals, pd.packed, pd.meta, pd.step_block,
                              x3d, out=poison, **kw)
    assert got.shape == ref.shape == (B, pd.num_row_tiles, 128)
    assert np.isfinite(got.numpy()).all()
    scale = bk.bell2_spmm_tiles_plain(
        pd.vals.abs().double(), pd.packed, pd.meta, pd.step_block,
        x3d.abs().double(), **kw,
    )
    assert allclose_spmv(got.numpy(), ref, np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy())
    for b in range(B):  # column by column, the MM twin is B2's twin
        yb = bk.bell2_spmv_tiles_plain(pd.vals, pd.packed, pd.meta,
                                       pd.step_block, x3d[b], **kw)
        assert torch.equal(yb, got[b])


@pytest.mark.parametrize("name", sorted(SPARSE))
def test_bell2_spmm_accum_plain_matches_reference(name):
    """B8: Y accumulated in place; blocks the stream never visits hold
    NaN and keep it."""
    make, depth, contig, grouped, holes = SPARSE[name]
    plan = make()
    _check_plan(plan, depth, contig, grouped, True)
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    es = pd.entries
    B = 2
    x3d_np = _x3d(plan.ncols, plan.x_rows, B, 12)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    y0 = np.random.default_rng(13).uniform(-1, 1, (B, TP, 128)).astype(
        np.float32
    )
    rows = _visited_rows(plan)
    untouched = np.setdiff1d(np.arange(TP), rows)
    assert (len(untouched) > 0) == holes
    y0[:, untouched] = np.nan
    ref = np.asarray(ref_bk.bell2_spmm_tiles_accum(
        rd.vals, rd.packed, rd.meta, rd.step_block, jnp.asarray(x3d_np),
        jnp.asarray(y0), **_ref_kw(rd),
    ))
    x3d = torch.from_numpy(x3d_np)
    y = torch.from_numpy(y0.copy())
    got = bk.bell2_spmm_tiles_accum(es, x3d, y)
    assert got.data_ptr() == y.data_ptr()  # accumulated in place
    assert np.isnan(got.numpy()[:, untouched]).all()
    scale = bk.bell2_spmm_tiles_accum_plain(
        _abs64(es), x3d.abs().double(),
        torch.from_numpy(np.abs(y0)).double(),
    )
    got_v = got.numpy()[:, rows]
    assert np.isfinite(got_v).all()
    assert allclose_spmv(got_v, ref[:, rows], np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale.numpy()[:, rows])
    for b in range(B):
        yb = bk.bell2_spmv_tiles_accum_plain(
            es, x3d[b], torch.from_numpy(y0[b].copy()))
        assert torch.equal(yb[rows], got[b, rows])


@pytest.mark.parametrize("B", [1, 8, 11])
@pytest.mark.parametrize("name", sorted(SPARSE))
def test_bell2_spmm_accum_planes_match_reference(name, B):
    """B8 at one plane, one full group and two groups, onto Y planes held
    at a plane stride past the plane, NaN in every row no entry names:
    against the reference on the rows the entries name, bit for bit on the
    others, and per column B4's twin."""
    plan = SPARSE[name][0]()
    rd = ref_ops.to_device(plan)
    pd = ops.to_device(plan, "cpu")
    es = pd.entries
    x3d_np = _x3d(plan.ncols, plan.x_rows, B, 21)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    T = es.min_tiles
    y0 = np.random.default_rng(22).uniform(-1, 1, (B, TP, 128)).astype(
        np.float32
    )
    ref = np.asarray(ref_bk.bell2_spmm_tiles_accum(
        rd.vals, rd.packed, rd.meta, rd.step_block, jnp.asarray(x3d_np),
        jnp.asarray(y0), **_ref_kw(rd),
    ))[:, :T].reshape(B, -1)
    mask = _untouched_mask(es, T)
    y1 = y0[:, :T].copy().reshape(B, -1)
    y1[:, mask] = np.nan
    wide = torch.full((B, T + 3, 128), float("inf"))
    wide[:, :T] = torch.from_numpy(y1.reshape(B, T, 128))
    x3d = torch.from_numpy(x3d_np)
    got = bk.bell2_spmm_tiles_accum(es, x3d, wide[:, :T])
    assert got.data_ptr() == wide.data_ptr()
    assert torch.isinf(wide[:, T:]).all()  # nothing past the planes moved
    got = got.numpy().reshape(B, -1)
    assert np.array_equal(got.view(np.int32)[:, mask],
                          y1.view(np.int32)[:, mask])
    scale = bk.bell2_spmm_tiles_accum_plain(
        _abs64(es), x3d.abs().double(),
        torch.from_numpy(np.abs(y0[:, :T])).double(),
    ).numpy().reshape(B, -1)
    assert np.isfinite(got[:, ~mask]).all()
    assert allclose_spmv(got[:, ~mask], ref[:, ~mask], np.float32,
                         nnz_per_row=plan.nnz / plan.nrows,
                         scale=scale[:, ~mask])
    for b in range(B):
        yb = bk.bell2_spmv_tiles_accum_plain(
            es, x3d[b], torch.from_numpy(y1[b].reshape(T, 128).copy()))
        assert np.array_equal(yb.numpy().reshape(-1)[~mask], got[b, ~mask])


def test_unperm_gather_mm_plain_matches_reference_exactly():
    """B9 on a grouped plan with absent rows (``pk < 0``), the grouped
    tiles given as a column slice of wider planes."""
    plan = _grouped_empty_rows()
    pd = ops.to_device(plan, "cpu")
    W = plan.unperm_slabs.shape[1]
    B, T = 2, plan.num_row_tiles
    g = np.random.default_rng(14).uniform(-1, 1, (B, T, 128)).astype(
        np.float32
    )
    ref = np.asarray(ref_bk.unperm_gather_tiles_mm(
        jnp.asarray(plan.unperm_pk), jnp.asarray(plan.unperm_slabs),
        jnp.asarray(g), W=W, interpret=True,
    ))
    wide = torch.full((B, T + 5, 128), float("nan"))
    wide[:, :T] = torch.from_numpy(g)
    got = bk.unperm_gather_tiles_mm(pd.unperm_pk, pd.unperm_slabs,
                                    wide[:, :T])
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)
    absent = plan.unperm_pk.reshape(-1) < 0
    assert absent.any()
    assert np.all(got.numpy().reshape(B, -1)[:, absent] == 0.0)
    for b in range(B):
        assert torch.equal(got[b], bk.unperm_gather_tiles_plain(
            pd.unperm_pk, pd.unperm_slabs, torch.from_numpy(g[b])))


@pytest.mark.parametrize("tw,bt", [(2, None), (4, None), (4, 8)])
def test_sbell_spmm_plain_matches_reference(tw, bt, monkeypatch):
    """B10 on forced paired plans, TW 2 and 4, one output block and
    (``bt=8``) four, into NaN-poisoned planes."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    csr = proxies.near_band_paired(n=4000, n_diags=32, max_off=300, seed=5)
    plan = ref_sbell_plan(csr, transpose_windows=tw, tiles_per_block=bt)
    assert plan.nnz_paired > 0 and plan.transpose_windows == tw
    assert len(np.unique(plan.step_block)) == (1 if bt is None else 4)
    pd = ops.sym_to_device(plan, "cpu")
    B = 2
    x3d_np = _x3d(plan.nrows, plan.x_rows, B, 15)
    kw = dict(num_row_tiles=plan.num_row_tiles,
              chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block, transpose_windows=tw)
    ref = np.asarray(ref_bk.sbell_spmm_tiles(
        jnp.asarray(plan.vals), jnp.asarray(plan.packed),
        jnp.asarray(plan.meta), jnp.asarray(plan.step_block),
        jnp.asarray(x3d_np), interpret=True, **kw,
    ))
    x3d = torch.from_numpy(x3d_np)
    TP = -(-plan.num_row_tiles // plan.tiles_per_block) * plan.tiles_per_block
    poison = torch.full((B, TP, 128), float("nan"))
    got = bk.sbell_spmm_tiles(pd.vals, pd.packed, pd.meta, pd.step_block,
                              x3d, out=poison, **kw)
    assert got.shape == ref.shape and np.isfinite(poison.numpy()).all()
    scale = bk.sbell_spmm_tiles_plain(
        pd.vals.abs().double(), pd.packed, pd.meta, pd.step_block,
        x3d.abs().double(), **kw,
    )
    assert allclose_spmv(got.numpy(), ref, np.float32,
                         nnz_per_row=2 * plan.nnz_paired / plan.nrows,
                         scale=scale.numpy())
    for b in range(B):
        yb = bk.sbell_spmv_tiles_plain(pd.vals, pd.packed, pd.meta,
                                       pd.step_block, x3d[b], **kw)
        assert torch.equal(yb, got[b])


def _none_stream():
    """The whole-matrix stream the untuned path (``Tuning.NONE``) uploads,
    at test size."""
    import cfs_spmv_tpu_torch as ct
    from cfs_spmv_tpu_torch.utils import proxies as port_proxies

    A = ct.SparseMatrix.create(port_proxies.cant_proxy(n=4096),
                               ct.Format.SSS)
    ct.SpDMV(A, ct.Tuning.NONE, device="cpu")
    return A.tuned.operands


@pytest.mark.parametrize("name,covers", [
    ("grouped", True), ("tuning_none", True), ("deep16_holes", False),
    ("flagship_far", False)])
def test_bell2_device_covers(name, covers):
    """``Bell2Device.covers``: True for streams whose chunk grid visits
    every output block (audikw's grouped far stream, the untuned whole
    stream), so that the kernel zeroes whole planes; False for the
    8-tile-block replan whose absent rows leave blocks unvisited and for a
    sparse residual (both travel as entries)."""
    if name == "tuning_none":
        d = _none_stream()
        assert isinstance(d, ops.Bell2Device) and d.vals is not None
    else:
        plan = {**DENSE, **SPARSE}[name][0]()
        d = ops.to_device(plan, "cpu")
        assert ops._visits_every_block(
            plan.step_block, plan.num_row_tiles,
            plan.tiles_per_block) == (name != "deep16_holes")
    assert d.covers == covers


@pytest.mark.parametrize("B", [1, 8, 11])
@pytest.mark.parametrize("name", ["contig8", "deep16_holes"])
def test_bell2_covers_zeroes_whole_planes(name, B):
    """The twins with ``covers``: on a stream that visits every block the
    whole NaN-poisoned planes come out finite and equal to the result
    without ``covers`` (the visited blocks zeroed one by one); on the
    replan whose blocks are not all visited, uncovered blocks keep their
    NaN. B = 1 runs B2's wrapper, 8 and 11 B7's."""
    plan = (DENSE_MM[name][0] if name in DENSE_MM else SPARSE[name][0])()
    covers = ops._visits_every_block(plan.step_block, plan.num_row_tiles,
                                     plan.tiles_per_block)
    assert covers == (name == "contig8")
    kw = dict(num_row_tiles=plan.num_row_tiles,
              chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block,
              contig=plan.windows_contig or plan.window_depth > 8)
    TP = -(-plan.num_row_tiles // plan.tiles_per_block) \
        * plan.tiles_per_block
    x3d = torch.from_numpy(_x3d(plan.ncols, plan.x_rows, B, 31))

    def run(cov):
        out = torch.full((B, TP, 128), float("nan"))
        if B == 1:
            bk.bell2_spmv_tiles(*_grid(plan), x3d[0], out=out[0], covers=cov,
                                **kw)
        else:
            bk.bell2_spmm_tiles(*_grid(plan), x3d, out=out, covers=cov, **kw)
        return out

    parent, got = run(False), run(covers)
    rows = _visited_rows(plan)
    rest = np.setdiff1d(np.arange(TP), rows)
    assert (len(rest) > 0) == (not covers)
    assert torch.equal(got[:, rows], parent[:, rows])
    assert torch.isfinite(got[:, rows]).all()
    if covers:
        assert torch.isfinite(got).all()
    else:
        assert torch.isnan(got[:, rest]).all()
    assert bk.bell2_spmv_tiles.launches == bk.bell2_spmm_tiles.launches == 0


@pytest.mark.parametrize("B", [1, 2, 3, 8, 9, 11])
@pytest.mark.parametrize("name", sorted(DENSE_MM))
def test_bell2_spmm_interleaved_x_matches_planes(name, B):
    """B7 over an interleaved X (``interleave_x``: a group's planes of an
    element side by side, 8 for a whole group and the instance width 1, 2,
    4 or 8 for the last, zero past the last plane): the helper holds the
    planes of ``pad_x_mm``, and the twin that reads it gives the planes
    twin's result bit for bit; the wrapper refuses a misshapen, mistyped
    or misaligned one."""
    plan = DENSE_MM[name][0]()
    pd = ops.to_device(plan, "cpu")
    X = torch.from_numpy(np.random.default_rng(B).uniform(
        -1, 1, (plan.ncols, B)).astype(np.float32))
    x3d = ops.pad_x_mm(X, plan.x_rows)
    x_il = bk.interleave_x(X, plan.x_rows)
    n = plan.x_rows * 128
    widths = {1: [1], 2: [2], 3: [4], 8: [8], 9: [8, 1], 11: [8, 4]}[B]
    assert bk.group_widths(B) == widths
    assert x_il.shape == (sum(widths), n) and x_il.is_contiguous()
    flat = x3d.reshape(B, -1)
    for b in range(B):
        b0, w = b - b % 8, widths[b // 8]
        block = x_il.reshape(-1)[b0 * n:(b0 + w) * n].view(n, w)
        assert torch.equal(block[:, b % 8], flat[b])
    last0, last_w = 8 * (len(widths) - 1), widths[-1]
    tail = x_il.reshape(-1)[last0 * n:].view(n, last_w)[:, B - last0:]
    assert (tail == 0).all()
    if B == 1:  # one plane is the plane
        assert torch.equal(x_il.view(-1), flat[0])
    assert torch.equal(bk.planes_of_interleaved(x_il, B), x3d)
    kw = dict(_port_kw(pd), covers=pd.covers)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    grid = (pd.vals, pd.packed, pd.meta, pd.step_block)
    want = bk.bell2_spmm_tiles(*grid, x3d,
                               out=torch.full((B, TP, 128), float("nan")),
                               **kw)
    got = bk.bell2_spmm_tiles(*grid, x_il, planes=B,
                              out=torch.full((B, TP, 128), float("nan")),
                              **kw)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    # a contiguous view 4 bytes into an aligned buffer
    shifted = torch.zeros(x_il.numel() + 8)[1:1 + x_il.numel()].view(
        x_il.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 32
    for bad, match in ((x_il[:, :-1].contiguous(), None), (x_il.double(), "float64"),
                       (torch.cat([x_il, x_il]), None),
                       (x_il.T.contiguous(), None), (shifted, "aligned")):
        with pytest.raises((ValueError, TypeError), match=match):
            bk.bell2_spmm_tiles(*grid, bad, planes=B, **kw)
    assert bk.bell2_spmm_tiles.launches == 0


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
    # the MM wrappers: X and Y as (B, rows, 128) float32 planes, each
    # contiguous, of one plane count; an output buffer wholly contiguous
    args = (pd.vals, pd.packed, pd.meta, pd.step_block)
    TP = -(-pd.num_row_tiles // pd.tiles_per_block) * pd.tiles_per_block
    x3d = torch.zeros((2, plan.x_rows, 128))
    y3d = torch.zeros((2, TP, 128))
    with pytest.raises(ValueError, match="x3d"):  # a 2-D x
        bk.bell2_spmm_tiles(*args, x2d, **kw)
    with pytest.raises(TypeError, match="float64.*float32"):
        bk.bell2_spmm_tiles(*args, x3d.double(), **kw)  # names both types
    with pytest.raises(ValueError, match="contiguous"):
        bk.bell2_spmm_tiles(*args, torch.zeros((2, 128, plan.x_rows))
                            .transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="out"):  # B of out differs
        bk.bell2_spmm_tiles(*args, x3d, out=y3d[:1].clone(), **kw)
    with pytest.raises(ValueError, match="out"):  # strided out planes
        bk.bell2_spmm_tiles(*args, x3d, out=torch.zeros((2, TP + 1, 128))
                            [:, :TP], **kw)
    # B4/B8 take the stream's entries
    es = bk.compact_stream(plan.vals, plan.packed, plan.meta,
                           plan.step_block, x_rows=plan.x_rows, **kw)
    with pytest.raises(ValueError, match="planes"):  # B of Y differs
        bk.bell2_spmm_tiles_accum(es, x3d, y3d[:1])
    with pytest.raises(ValueError, match="rows"):  # Y short of a row
        bk.bell2_spmm_tiles_accum(es, x3d, y3d[:, : es.min_tiles - 1])
    with pytest.raises(ValueError, match="rows"):  # x short of a column
        bk.bell2_spmm_tiles_accum(es, x3d[:, : es.min_x_rows - 1], y3d)
    with pytest.raises(ValueError, match="no planes|planes"):  # B = 0
        bk.bell2_spmm_tiles_accum(es, x3d[:0], y3d[:0])
    with pytest.raises(ValueError, match="rows"):
        bk.bell2_spmv_tiles_accum(es, x2d, y3d[0, : es.min_tiles - 1])
    with pytest.raises(TypeError, match="float64.*float32"):
        bk.bell2_spmv_tiles_accum(es, x2d.double(), y3d[0])
    with pytest.raises(TypeError, match="float64.*float32"):
        bk.bell2_spmm_tiles_accum(es, x3d, y3d.double())
    with pytest.raises(ValueError, match="int32"):
        bk.bell2_spmv_tiles_accum(
            bk.EntryStream(es.rows.long(), es.cols, es.vals, es.min_tiles,
                           es.min_x_rows), x2d, y3d[0])
    g = _audikw_far()
    gd = ops.to_device(g, "cpu")
    with pytest.raises(ValueError, match="g_tiles"):
        bk.unperm_gather_tiles_mm(gd.unperm_pk, gd.unperm_slabs,
                                  torch.zeros((g.num_row_tiles, 128)))
    with pytest.raises(ValueError, match="int32"):
        bk.unperm_gather_tiles_mm(gd.unperm_pk.long(), gd.unperm_slabs,
                                  torch.zeros((1, g.num_row_tiles, 128)))
    for w in (bk.bell2_spmv_tiles, bk.bell2_spmv_tiles_accum,
              bk.unperm_gather_tiles, bk.sbell_spmv_tiles,
              bk.bell2_spmm_tiles, bk.bell2_spmm_tiles_accum,
              bk.unperm_gather_tiles_mm, bk.sbell_spmm_tiles):
        assert w.launches == 0


# -- the paired kernel's walk (B5/B10 on the card), modelled on the CPU -----
#
# The CUDA kernel gives each CTA ``cpc`` consecutive chunks. It keeps the
# row sums and one sum per transpose-window slot while their targets stay
# the same, hands a slot's sums over when its target changes (into the row
# sums when the target is the row's own tile, else into y) and flushes
# everything at the end of its walk. The model below is that walk in numpy,
# CTA by CTA, in float64: it must give the twin's result for every split of
# the chunks over CTAs, and every chunk must lie in exactly one CTA's range.

def _paired_holes_csr():
    """``near_band_paired`` without rows and columns 1100-2999."""
    coo = proxies.near_band_paired(n=4000, n_diags=32, max_off=300,
                                   seed=5).to_coo()
    keep = (((coo.row < 1100) | (coo.row >= 3000))
            & ((coo.col < 1100) | (coo.col >= 3000)))
    return RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                  coo.col[keep], coo.val[keep],
                                  symmetric=True))


#: name -> (matrix factory, TW, tiles per block, output blocks)
PAIRED_WALKS = {
    "tw2": (lambda: proxies.near_band_paired(n=4000, n_diags=32,
                                             max_off=300, seed=5), 2, None, 1),
    "tw4": (lambda: proxies.near_band_paired(n=4000, n_diags=32,
                                             max_off=300, seed=5), 4, None, 1),
    "tw4_bt8_holes": (_paired_holes_csr, 4, 8, 4),
}


def _sbell_walk(plan, x2d, cpc):
    """(y tiles, times each chunk was walked, adds into y) of the paired
    kernel's walk with ``cpc`` chunks a CTA."""
    K, BT, TW = (plan.chunks_per_step, plan.tiles_per_block,
                 plan.transpose_windows)
    meta, sb = np.asarray(plan.meta), np.asarray(plan.step_block)
    C = meta.shape[0]
    pk_all = np.asarray(plan.packed).reshape(C, 8, 128).astype(np.int64)
    v_all = np.asarray(plan.vals, np.float64).reshape(C, 8, 128)
    TP = -(-plan.num_row_tiles // BT) * BT
    y = np.zeros((TP, 128))
    seen = np.zeros(C, np.int64)
    adds = 0
    for c0 in range(0, C, cpc):  # one CTA
        row, acc = -1, np.zeros(128)
        wt, ts = [-1] * TW, np.zeros((TW, 128))
        for c in range(c0, min(c0 + cpc, C)):
            seen[c] += 1
            w = meta[c, 2:2 + TW]
            tgt = int(sb[c // K]) * BT + int(meta[c, 0])
            pk, v = pk_all[c], v_all[c]
            xo, xw = x2d[tgt], x2d[w]  # the tiles the kernel stages
            for t in range(TW):
                if w[t] != wt[t]:
                    if wt[t] == row:
                        acc = acc + ts[t]
                    elif wt[t] >= 0:
                        y[wt[t]] += ts[t]
                        adds += 1
                    wt[t], ts[t] = int(w[t]), 0.0
            if tgt != row:
                if row >= 0:
                    y[row] += acc
                    adds += 1
                row, acc = tgt, np.zeros(128)
            q = pk & 0x7F
            r2 = np.take_along_axis((pk >> 7) & 7, q, axis=1)
            got = xw[np.minimum(r2, TW - 1), q]
            acc = acc + np.where(r2 < TW, v * got, 0.0).sum(axis=0)
            t2, src = (pk >> 7) & 7, (pk >> 10) & 0x7F
            p = np.take_along_axis(v, src, axis=1) * xo[src]
            for t in range(TW):
                ts[t] += np.where(t2 == t, p, 0.0).sum(axis=0)
        for t in range(TW):
            if wt[t] == row:
                acc = acc + ts[t]
            elif wt[t] >= 0:
                y[wt[t]] += ts[t]
                adds += 1
        if row >= 0:
            y[row] += acc
            adds += 1
    return y, seen, adds


@pytest.mark.parametrize("cpc", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(PAIRED_WALKS))
def test_sbell_walk_model_matches_twin(name, cpc, monkeypatch):
    """The walk of the CUDA kernel, modelled in numpy, against the twin in
    float64 (same products, another order: 1e-12 of |L| |x|), on TW = 2
    and 4, and on an 8-tile-block replan with an absent row range, whose
    plan has K-padding chunks, covering chunks of empty blocks and windows
    that are the chunk's own tile."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    make, tw, bt, blocks = PAIRED_WALKS[name]
    plan = ref_sbell_plan(make(), transpose_windows=tw, tiles_per_block=bt)
    assert plan.nnz_paired > 0 and plan.transpose_windows == tw
    assert len(np.unique(plan.step_block)) == blocks
    pd = ops.sym_to_device(plan, "cpu")  # the upload's index checks pass
    K, BT = plan.chunks_per_step, plan.tiles_per_block
    meta = np.asarray(plan.meta)
    C = meta.shape[0]
    tgt = np.repeat(np.asarray(plan.step_block, np.int64), K) * BT + meta[:, 0]
    own = (meta[:, 2:2 + tw] == tgt[:, None]).any(axis=1)
    empty = np.abs(np.asarray(plan.vals)).reshape(C, -1).sum(axis=1) == 0
    assert own.any() and not own.all()
    if name == "tw4_bt8_holes":
        assert empty.sum() >= K  # padding and covering chunks
    x = np.random.default_rng(6).uniform(10.01, 20.42, plan.nrows)
    x2d = np.zeros((plan.x_rows, 128))
    x2d.reshape(-1)[: plan.nrows] = x
    y, seen, adds = _sbell_walk(plan, x2d, cpc)
    assert np.array_equal(seen, np.ones(C, np.int64))
    kw = dict(num_row_tiles=plan.num_row_tiles, chunks_per_step=K,
              tiles_per_block=BT, transpose_windows=tw)
    args = (pd.packed, pd.meta, pd.step_block)
    x2d_t = torch.from_numpy(x2d)
    want = bk.sbell_spmv_tiles_plain(pd.vals.double(), *args, x2d_t, **kw)
    scale = bk.sbell_spmv_tiles_plain(pd.vals.abs().double(), *args,
                                      x2d_t.abs(), **kw)
    err = np.abs(y[: plan.num_row_tiles] - want.numpy())
    assert (err <= 1e-12 * np.maximum(scale.numpy(), 1e-300)).all()
    assert not y[plan.num_row_tiles:].any()
    # a longer walk carries more sums: fewer adds into y than one chunk a
    # CTA, which itself makes at most 1 + TW adds a chunk
    _, _, adds1 = _sbell_walk(plan, x2d, 1)
    assert adds1 <= (1 + tw) * C
    assert adds <= adds1 and (cpc == 1 or adds < adds1)


# -- the one-sided kernel's walks (B2 on the card), modelled on the CPU -----
#
# The CUDA kernel runs CTAs of 8 walk groups of 128 threads; group g of CTA
# b walks the chunks [w * cpc, min((w + 1) * cpc, C)), w = 8 b + g, where
# cpc is the fewest chunks a walk that keep every group resident at once
# (the launcher's occupancy rule, with no cap), so any cpc >= 1 can occur,
# and a walk may start and end inside a row's run of chunks; the last
# CTA's last walks may be empty. A walk sums each chunk into a register of
# its own and joins it to one running row sum; a row that begins and ends
# inside the walk is flushed on the change of row, and the walk's first
# and last rows are kept for the CTA, which adds them up in walk order, one
# add per row and CTA. No sum that is exactly 0 is added. The model below
# is that in numpy, walk by walk and CTA by CTA, in float64: every chunk
# must lie in exactly one walk, the sums must give the twin's result, and
# a row must take no more adds than there are CTAs holding a nonzero chunk
# of it, so at most two where its nonzero chunks span 8 * cpc + 1 chunks
# or fewer (then its bits do not depend on the order the CTAs finish).

B2_GROUPS = 8


def _bell2_walks(arrays, x2d, cpc):
    """(y tiles, times each chunk was summed, adds into y per (tile,
    lane), walks that start inside a row's run of chunks, CTAs holding a
    nonzero chunk per tile) of the kernel's walks over ``arrays`` = (vals,
    packed, meta, step_block, K, BT, contig, TP)."""
    vals, packed, meta, sb, K, BT, contig, TP = arrays
    C = meta.shape[0]
    pk_all = packed.reshape(C, 8, 128).astype(np.int64)
    v_all = vals.reshape(C, 8, 128)
    tgt_all = sb.astype(np.int64)[np.arange(C) // K] * BT + meta[:, 0]
    live = np.abs(v_all).reshape(C, -1).sum(axis=1) > 0
    y = np.zeros((TP, 128))
    seen = np.zeros(C, np.int64)
    adds = np.zeros((TP, 128), np.int64)
    holders = np.zeros(TP, np.int64)
    mid = 0
    zeros = np.zeros(128)

    def add(row, s):
        nz = s != 0
        y[row, nz] += s[nz]
        adds[row] += nz

    walks = -(-C // cpc)
    walks = -(-walks // B2_GROUPS) * B2_GROUPS
    ends = []  # per walk: its first and last rows (-1: none) and sums
    for w in range(walks):
        c0 = w * cpc
        mid += 0 < c0 < C and tgt_all[c0] == tgt_all[c0 - 1]
        head = row = -1
        head_sum = acc = zeros
        for c in range(c0, min(c0 + cpc, C)):
            seen[c] += 1
            pk = pk_all[c]
            q = pk & 0x7F
            r2 = (np.take_along_axis(pk, q, axis=1) >> 7) & 0x1F
            xrow = meta[c, 2] + r2 if contig else meta[c, 2 + (r2 & 7)]
            own = (v_all[c] * x2d[xrow, q]).sum(axis=0)
            if tgt_all[c] != row:
                if row < 0:
                    head = int(tgt_all[c])
                elif row == head:
                    head_sum = acc
                else:
                    add(row, acc)
                row, acc = int(tgt_all[c]), zeros
            acc = acc + own
        one = row == head
        ends += [(head, acc if one else head_sum),
                 (-1 if one else row, zeros if one else acc)]
    for k0 in range(0, 2 * walks, 2 * B2_GROUPS):  # one CTA
        seq = [e for e in ends[k0:k0 + 2 * B2_GROUPS] if e[0] >= 0]
        for k, (r, _) in enumerate(seq):
            if k and seq[k - 1][0] == r:
                continue  # an earlier entry's run adds it
            s = zeros
            for r_, s_ in seq[k:]:
                if r_ != r:
                    break
                s = s + s_
            add(r, s)
        first = min(C, k0 // 2 * cpc)
        rows = tgt_all[first:min(C, first + B2_GROUPS * cpc)]
        holders[np.unique(rows[live[first:first + len(rows)]])] += 1
    return y, seen, adds, mid, holders


#: name -> (plan factory, contiguous windows, visited output blocks at
#: least, some blocks unvisited, all-zero chunks: K-padding)
B2_WALKS = {
    "contig8": (_band(300), True, 1, False, True),
    "listed": (_listed, False, 1, False, False),
    "grouped": (_audikw_far, True, 1, False, True),
    "deep16_holes_bt8": (_band_with_holes, True, 2, True, True),
}
_B2_PLANS = {}


def _b2_plan(name):
    if name not in _B2_PLANS:
        _B2_PLANS[name] = B2_WALKS[name][0]()
    return _B2_PLANS[name]


@pytest.mark.parametrize("values", ["float32", "bfloat16"])
@pytest.mark.parametrize("cpc", [1, 2, 5, 7])
@pytest.mark.parametrize("name", sorted(B2_WALKS))
def test_bell2_walk_model_matches_twin(name, cpc, values):
    """The kernel's walks, 8 a CTA, modelled in numpy, against the twin in
    float64 (same products, another order: 1e-12 of |A| |x|), with float32
    and with bf16 values (widened exactly), on contiguous and listed
    windows, a degree-grouped stream and an 8-tile-block replan with an
    absent row range (unvisited blocks, which the walks never add into);
    three of the plans have K-padding chunks (all zero, forward-filled
    meta), which add exactly 0."""
    make, contig, blocks, holes, padded = B2_WALKS[name]
    plan = _b2_plan(name)
    ops.to_device(plan, "cpu")  # the upload's index checks pass
    assert (plan.windows_contig or plan.window_depth > 8) == contig
    K, BT = plan.chunks_per_step, plan.tiles_per_block
    meta = np.asarray(plan.meta).astype(np.int64)
    C = meta.shape[0]
    sb = np.asarray(plan.step_block)
    assert len(np.unique(sb)) >= blocks
    TP = -(-plan.num_row_tiles // BT) * BT
    vt = torch.from_numpy(np.asarray(plan.vals, np.float32))
    if values == "bfloat16":
        vt = vt.to(torch.bfloat16)
    v64 = vt.double().numpy()
    empty = np.abs(v64).reshape(C, -1).sum(axis=1) == 0
    assert empty.any() == padded
    x = np.random.default_rng(6).uniform(10.01, 20.42, plan.ncols)
    x2d = np.zeros((plan.x_rows, 128))
    x2d.reshape(-1)[: plan.ncols] = x
    arrays = (v64, np.asarray(plan.packed), meta, sb, K, BT, contig, TP)
    kw = dict(num_row_tiles=plan.num_row_tiles, chunks_per_step=K,
              tiles_per_block=BT, contig=contig)
    args = (torch.from_numpy(np.asarray(plan.packed)),
            torch.from_numpy(np.asarray(plan.meta)),
            torch.from_numpy(sb))
    x2d_t = torch.from_numpy(x2d)
    want = bk.bell2_spmv_tiles_plain(
        vt, *args, x2d_t, out=torch.full((TP, 128), float("nan"),
                                         dtype=torch.float64), **kw).numpy()
    scale = bk.bell2_spmv_tiles_plain(vt.abs(), *args, x2d_t.abs(),
                                      **kw).numpy()
    in_blocks = (np.unique(sb)[:, None] * BT + np.arange(BT)).ravel()
    visited = in_blocks[in_blocks < plan.num_row_tiles]
    unvisited = np.setdiff1d(np.arange(TP), in_blocks)
    assert (len(unvisited) > 0) == holes
    assert np.isnan(want[unvisited[unvisited < plan.num_row_tiles]]).all()
    # the span of each row's nonzero chunks, first to last
    nz = np.abs(v64).reshape(C, -1).sum(axis=1) > 0
    tgt = sb.astype(np.int64)[np.arange(C) // K] * BT + meta[:, 0]
    first, last = np.full(TP, C), np.full(TP, -1)
    np.minimum.at(first, tgt[nz], np.nonzero(nz)[0])
    np.maximum.at(last, tgt[nz], np.nonzero(nz)[0])
    short = last - first < B2_GROUPS * cpc + 1  # spans 8 cpc + 1 or fewer
    y, seen, adds, mid, holders = _bell2_walks(arrays, x2d, cpc)
    assert np.array_equal(seen, np.ones(C, np.int64))
    err = np.abs(y[visited] - want[visited])
    assert (err <= 1e-12 * np.maximum(scale[visited], 1e-300)).all()
    assert not y[unvisited].any() and not adds[unvisited].any()
    assert (adds <= holders[:, None]).all()  # padding adds nothing
    assert (adds[short] <= 2).all()
    if cpc > 1:
        assert mid > 0  # walks that start inside a row's chunks
    # CTAs of longer walks have fewer edges: no more adds than CTAs of one
    # chunk a walk make
    assert adds.sum() <= _bell2_walks(arrays, x2d, 1)[2].sum()


# -- the fused unpermute forms of the symmetric applier (B3/B9) -------------


def _grouped_holes():
    """A degree-grouped plan over 8-tile output blocks whose rows
    1000-2199 have no entries: they are absent from the unpermute (pk <
    0), as are the other empty rows."""
    rng = np.random.default_rng(2)
    n = 3000
    deg = np.zeros(n, np.int64)
    live = rng.choice(n, n // 2, replace=False)
    live = live[(live < 1000) | (live >= 2200)]
    deg[live] = rng.integers(1, 6, len(live))
    deg[live[:4]] = 300
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    col = rng.integers(0, n, len(row)).astype(np.int64)
    val = rng.uniform(-1, 1, len(row))
    return build_bell2_plan(
        RefCSR.from_coo(RefCOO(n, n, row, col, val).canonicalize()),
        tiles_per_block=8)


UNPERM_PLANS = {"audikw_far": _audikw_far, "grouped_holes": _grouped_holes}


@pytest.mark.parametrize("form", ["seed", "into"])
@pytest.mark.parametrize("B", [None, 1, 3, 8])
@pytest.mark.parametrize("name", sorted(UNPERM_PLANS))
def test_unperm_gather_fused_forms_match_reference_composed(name, B, form):
    """B3/B9's fused forms, bit for bit (``torch.equal``) the reference's
    ``unperm_gather_tiles(_mm)`` (interpret mode) followed by the ops
    ``sbell_apply`` composed: ``seed`` = (diag, x) gives the pad of
    ``diag * x`` to the output's tiles plus the gather padded to them (a
    few tiles past the gather's, and rows past x's end); ``into`` adds
    the padded gather into given tiles. X (B planes, ``None`` the SpMV
    wrapper) sits at strides of its own; rows the gather leaves absent
    read exactly the seed, or the tiles they were added into."""
    plan = UNPERM_PLANS[name]()
    pd = ops.to_device(plan, "cpu")
    assert pd.grouped and (name != "grouped_holes"
                           or plan.tiles_per_block == 8)
    W = plan.unperm_slabs.shape[1]
    Bp = B or 1
    n, T = plan.nrows, plan.num_row_tiles
    NT = -(-n // 128) + 3  # the output a few tiles past the gather's
    rng = np.random.default_rng(hash((name, Bp, form)) % 2**32)
    g = rng.uniform(-1, 1, (Bp, T, 128)).astype(np.float32)
    diag = rng.uniform(-2, 2, n).astype(np.float32)
    X = rng.uniform(10.01, 20.42, (Bp, n)).astype(np.float32)  # X.T: strided
    into0 = rng.uniform(-1, 1, (Bp, NT, 128)).astype(np.float32)
    ref = np.asarray(ref_bk.unperm_gather_tiles_mm(
        jnp.asarray(plan.unperm_pk), jnp.asarray(plan.unperm_slabs),
        jnp.asarray(g), W=W, interpret=True)).reshape(Bp, -1)
    pad = np.zeros((Bp, NT * 128), np.float32)
    pad[:, :ref.shape[1]] = ref[:, :NT * 128]
    if form == "seed":
        base = np.zeros((Bp, NT * 128), np.float32)
        base[:, :n] = diag[None, :] * X  # float32 products, rounded once
    else:
        base = into0.reshape(Bp, -1)
    want = (base + pad).reshape(Bp, NT, 128)

    Xt = torch.from_numpy(X).T  # (n, B) at strides (1, n)
    gt = torch.from_numpy(g)
    a = (pd.unperm_pk, pd.unperm_slabs)
    if B is None:
        kw = (dict(seed=(torch.from_numpy(diag), Xt[:, 0]), tiles=NT)
              if form == "seed" else dict(into=torch.from_numpy(into0[0])))
        got = bk.unperm_gather_tiles(*a, gt[0], **kw)[None]
    else:
        kw = (dict(seed=(torch.from_numpy(diag), Xt), tiles=NT)
              if form == "seed" else dict(into=torch.from_numpy(into0)))
        got = bk.unperm_gather_tiles_mm(*a, gt, **kw)
    if form == "into":  # added in place, and returned
        assert got.data_ptr() == kw["into"].data_ptr()
    assert got.shape == (Bp, NT, 128) and got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(want))
    absent = np.nonzero(plan.unperm_pk.reshape(-1)[:n] < 0)[0]
    assert (len(absent) > 0) == (name == "grouped_holes")
    flat = got.numpy().reshape(Bp, -1)
    assert np.array_equal(flat[:, absent], base[:, absent])
    assert np.array_equal(flat[:, n:], base[:, n:] + pad[:, n:])
    assert bk.unperm_gather_tiles.launches == 0
    assert bk.unperm_gather_tiles_mm.launches == 0


def test_unperm_gather_fused_forms_check_operands():
    """The fused forms refuse what their kernel cannot take."""
    plan = _audikw_far()
    pd = ops.to_device(plan, "cpu")
    a = (pd.unperm_pk, pd.unperm_slabs)
    n, T = plan.nrows, plan.num_row_tiles
    NT = -(-n // 128)
    g1, g2 = torch.zeros((T, 128)), torch.zeros((2, T, 128))
    diag, x, X = torch.ones(n), torch.ones(n), torch.ones((n, 2))
    with pytest.raises(ValueError, match="tile count"):  # no tiles
        bk.unperm_gather_tiles(*a, g1, seed=(diag, x))
    with pytest.raises(ValueError, match="tile count"):  # too few
        bk.unperm_gather_tiles(*a, g1, seed=(diag, x), tiles=NT - 1)
    with pytest.raises(ValueError, match="not both"):
        bk.unperm_gather_tiles(*a, g1, seed=(diag, x), tiles=NT,
                               into=torch.zeros((NT, 128)))
    with pytest.raises(ValueError, match="height"):  # tiles, no seed
        bk.unperm_gather_tiles(*a, g1, tiles=NT)
    with pytest.raises(ValueError, match="seed's x"):  # x's length
        bk.unperm_gather_tiles(*a, g1, seed=(diag, x[:-1]), tiles=NT)
    with pytest.raises(ValueError, match="seed's x"):  # X's plane count
        bk.unperm_gather_tiles_mm(*a, g2, seed=(diag, X[:, :1]), tiles=NT)
    with pytest.raises(TypeError, match="float64"):
        bk.unperm_gather_tiles_mm(*a, g2, seed=(diag.double(), X), tiles=NT)
    with pytest.raises(ValueError, match="into"):  # strided into planes
        bk.unperm_gather_tiles_mm(
            *a, g2, into=torch.zeros((2, NT, 130))[:, :, :128])
    with pytest.raises(ValueError, match="planes"):  # B of into differs
        bk.unperm_gather_tiles_mm(*a, g2, into=torch.zeros((1, NT, 128)))
    assert bk.unperm_gather_tiles.launches == 0
    assert bk.unperm_gather_tiles_mm.launches == 0
