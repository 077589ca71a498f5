"""The double paired kernel over planes (B10 f64, ``sbell_planes_kernel``)
and the staged double signed diagonal kernel (B6/B12 f64,
``sdia_gen_staged_kernel``), which the float64 ``DistSpDMV`` runs on its
paired shards and mirrored diagonals: their addressing, modelled in numpy,
against the float64 twins, and the wrappers' grouping of planes and
staging arguments.

The CUDA kernels run only on the card; what these tests hold is what they
read and where. B10 f64 walks a CTA's chunks over a group of up to 8
planes in one pass, and stages a chunk's own x tile and its window tiles
in shared memory only when the tile changes from the previous chunk of the
walk (when the sums of that tile are handed over); the model reads x only
through its staged copies, so a tile left stale gives a wrong y, and it
counts its stagings against an independent count of the changes. B12 f64
stages each CTA's window of X, rows ``[r0 - hi, r0 + rows + span - hi)``,
zero outside x, and reads every diagonal's x there: the model checks that
every read lies in the window and gives ``sdia_gen_kernel``'s sums bit for
bit at the same slices.

The plans are small float64 shard plans of the port's ``DistSpDMV``: a
paired shard (near-banded, ``CFS_PAIRED=force``) and a paired replan over
8-tile output blocks with an absent row range, a mirrored shard
(``CFS_DIST_SDIA_ROWS_MAX`` below the shard) and a mirrored shard of a band
with an absent row range, at B = 8 (one group) and 11 (two). Tolerance:
1e-12 of the twin on |A| |x| (the same products summed in another order).
"""

import contextlib

import numpy as np
import pytest
import torch

from cfs_spmv_tpu.utils.proxies import near_band_paired as ref_nbp
from cfs_spmv_tpu_torch.formats.coo import COO
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops import _cuda
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
from cfs_spmv_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_dist import _band, port_csr

torch.set_num_threads(1)

#: planes a launch serves, in every value type
GROUP = 8
#: ``kGenThreads`` of ``csrc/spmv_kernels.cu``: a CTA of the signed kernel
GEN_THREADS = 256


def _paired_holes():
    """``near_band_paired`` without rows and columns 1100-2999."""
    coo = ref_nbp(n=4000, n_diags=32, max_off=300, seed=5).to_coo()
    keep = (((coo.row < 1100) | (coo.row >= 3000))
            & ((coo.col < 1100) | (coo.col >= 3000)))
    return CSR.from_coo(COO(coo.nrows, coo.ncols, coo.row[keep],
                            coo.col[keep], coo.val[keep], symmetric=True))


def _paired_plan(name, monkeypatch):
    """The float64 paired host plan of ``name``: shard 1 of a 4-shard
    operator, or the replan over 8-tile blocks with absent rows."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    if name == "shard":
        csr = port_csr(ref_nbp(n=4096, n_diags=24, max_off=300, seed=3))
        port = DistSpDMV(csr, make_mesh(4, device="cpu"), dtype=np.float64)
        plan = port.plans[1].paired
    else:
        plan = build_sbell_plan(_paired_holes(), dtype=np.float64,
                                tiles_per_block=8, transpose_windows=2,
                                dia=False)
        assert len(np.unique(plan.step_block)) == 4
    assert plan.nnz_paired > 0 and np.asarray(plan.vals).dtype == np.float64
    return plan


def _planes_walk(plan, x3d, cpc, keep=True):
    """(Y tiles (B, TP, 128), x tiles staged) of ``sbell_planes_kernel``:
    one pass over the stream for each group of up to 8 planes, CTAs of
    ``cpc`` chunks. A CTA stages the chunk's own x tile of every plane of
    the group when its row tile is not the previous chunk's, and window
    slot t's tiles when the slot's tile changes (``keep`` False: every
    chunk), and reads x only through those copies; row and window sums
    are handed over as ``sbell_spmv_kernel`` does. A staging is one tile
    of one plane."""
    K, BT, TW = (plan.chunks_per_step, plan.tiles_per_block,
                 plan.transpose_windows)
    meta, sb = np.asarray(plan.meta), np.asarray(plan.step_block)
    C = meta.shape[0]
    pk = np.asarray(plan.packed).reshape(C, 8, 128).astype(np.int64)
    v_all = np.asarray(plan.vals, np.float64).reshape(C, 8, 128)
    TP = -(-plan.num_row_tiles // BT) * BT
    B = x3d.shape[0]
    y = np.zeros((B, TP, 128))
    staged = 0
    for g0 in range(0, B, GROUP):
        xs = x3d[g0:g0 + GROUP]
        nb = xs.shape[0]
        for c0 in range(0, C, cpc):  # one CTA
            row, acc = -1, np.zeros((nb, 128))
            wt, ts = [-1] * TW, np.zeros((TW, nb, 128))
            xo = np.full((nb, 128), np.nan)
            xw = np.full((TW, nb, 128), np.nan)
            for c in range(c0, min(c0 + cpc, C)):
                w = meta[c, 2:2 + TW]
                tgt = int(sb[c // K]) * BT + int(meta[c, 0])
                if not keep or tgt != row:
                    xo = xs[:, tgt].copy()
                    staged += nb
                for t in range(TW):
                    if not keep or w[t] != wt[t]:
                        xw[t] = xs[:, w[t]]
                        staged += nb
                for t in range(TW):
                    if w[t] != wt[t]:
                        if wt[t] == row:
                            acc = acc + ts[t]
                        elif wt[t] >= 0:
                            y[g0:g0 + nb, wt[t]] += ts[t]
                        wt[t], ts[t] = int(w[t]), 0.0
                if tgt != row:
                    if row >= 0:
                        y[g0:g0 + nb, row] += acc
                    row, acc = tgt, np.zeros((nb, 128))
                p, v = pk[c], v_all[c]
                q = p & 0x7F
                r2 = np.take_along_axis((p >> 7) & 7, q, axis=1)
                got = xw[np.minimum(r2, TW - 1), :, q]  # (8, 128, nb)
                acc = acc + np.where((r2 < TW)[..., None], v[..., None] * got,
                                     0.0).sum(axis=0).T
                t2, src = (p >> 7) & 7, (p >> 10) & 0x7F
                prod = (np.take_along_axis(v, src, axis=1)[..., None]
                        * xo[:, src].transpose(1, 2, 0))  # (8, 128, nb)
                for t in range(TW):
                    ts[t] += np.where((t2 == t)[..., None], prod,
                                      0.0).sum(axis=0).T
            for t in range(TW):
                if wt[t] == row:
                    acc = acc + ts[t]
                elif wt[t] >= 0:
                    y[g0:g0 + nb, wt[t]] += ts[t]
            if row >= 0:
                y[g0:g0 + nb, row] += acc
    return y, staged


def _changes(plan, cpc):
    """Tiles a CTA walk stages for one plane: each CTA's first chunk
    stages its own tile and TW window tiles, a later chunk the ones whose
    tile differs from the previous chunk's."""
    K, BT, TW = (plan.chunks_per_step, plan.tiles_per_block,
                 plan.transpose_windows)
    meta = np.asarray(plan.meta)
    C = meta.shape[0]
    tgt = (np.repeat(np.asarray(plan.step_block, np.int64), K) * BT
           + meta[:, 0])
    tiles = np.concatenate([tgt[:, None], meta[:, 2:2 + TW]], axis=1)
    first = np.arange(C) % cpc == 0
    moved = np.ones_like(tiles, dtype=bool)
    moved[1:] = tiles[1:] != tiles[:-1]
    moved[first] = True
    return int(moved.sum())


@pytest.mark.parametrize("B", [8, 11])
@pytest.mark.parametrize("cpc", [1, 2, 3])
@pytest.mark.parametrize("name", ["shard", "bt8_holes"])
def test_sbell_planes_walk_model_matches_twin(name, cpc, B, monkeypatch):
    """B10 f64's one pass over a group of up to 8 planes, its tiles staged
    on a change only, as the numpy model: the twin's Y within 1e-12 of
    |L| |X| (absent rows exact 0), stagings equal to the walks' tile
    changes, fewer than restaging at every chunk (which gives the same Y
    bit for bit) once a walk holds two chunks or more."""
    plan = _paired_plan(name, monkeypatch)
    pd = ops.sym_to_device(plan, "cpu")
    K, BT, TW = (plan.chunks_per_step, plan.tiles_per_block,
                 plan.transpose_windows)
    C = np.asarray(plan.meta).shape[0]
    x3d = np.zeros((B, plan.x_rows, 128))
    x = np.random.default_rng(60 + B).uniform(10.01, 20.42,
                                              (B, plan.nrows))
    x3d.reshape(B, -1)[:, :plan.nrows] = x
    y, staged = _planes_walk(plan, x3d, cpc)
    kw = dict(num_row_tiles=plan.num_row_tiles, chunks_per_step=K,
              tiles_per_block=BT, transpose_windows=TW)
    args = (pd.packed, pd.meta, pd.step_block)
    want = bk.sbell_spmm_tiles_plain(pd.vals, *args, torch.from_numpy(x3d),
                                     **kw).numpy()
    scale = bk.sbell_spmm_tiles_plain(pd.vals.abs(), *args,
                                      torch.from_numpy(x3d), **kw).numpy()
    NT = plan.num_row_tiles
    assert (np.abs(y[:, :NT] - want) <= 1e-12 * scale).all()
    assert not y[:, NT:].any()
    if name == "bt8_holes":
        flat = y.reshape(B, -1)
        assert not flat[:, 1100:3000].any()
    assert staged == B * _changes(plan, cpc)
    y_every, every = _planes_walk(plan, x3d, cpc, keep=False)
    assert every == B * C * (1 + TW)
    assert np.array_equal(y_every, y)
    if cpc == 1:
        assert staged == every
    else:
        assert staged < every


# -- B12 f64: the staged window -------------------------------------------


def _mirrored_shard(name, monkeypatch):
    """(near part, first global row) of a shard of an 8-shard float64
    operator whose union diagonals are stored mirrored: shard 3 of a band,
    or shard 2 of the band without rows 1100-2999, which holds some."""
    monkeypatch.setenv("CFS_DIST_SDIA_ROWS_MAX", "256")
    holes = (1100, 3000) if name == "holes" else None
    port = DistSpDMV(port_csr(_band(4096, 6, 7, holes=holes)),
                     make_mesh(8, device="cpu"), dia_min_count=8,
                     dtype=np.float64)
    d = 2 if holes else 3
    sh = port.shards[d].near
    assert sh.dia_mirrored and sh.dia_vals.dtype == torch.float64
    return sh, port.real[d][0]


def _staged_model(vals, x_flat, y, offsets, slices, store, window):
    """(Y, rows of x read) of ``sdia_gen_staged_kernel`` over the (B,
    x_len) planes ``x_flat`` and (B, y_len) planes ``y``: a CTA of 256 /
    slices rows first stages xsh[b][k] = x[r0 - hi + k] for k below rows +
    span (0 outside x), then thread (r, s) sums diagonals s, s + slices,
    ... of row r0 + r from xsh[.][r + hi - d]; the slices' sums join in
    slice order."""
    hi, span = window
    R, D = vals.shape[:2]
    nv = R * 1024
    vd = vals.transpose(1, 0, 2, 3).reshape(D, nv)
    B, XL = x_flat.shape
    YL = y.shape[1]
    out = y.copy()
    n_rows = YL if store else min(YL, nv)
    rows = GEN_THREADS // slices
    read = np.zeros(XL, bool)
    for r0 in range(0, n_rows, rows):
        width = rows + span
        src = r0 - hi + np.arange(width)
        ok = (src >= 0) & (src < XL)
        xsh = np.where(ok, x_flat[:, np.clip(src, 0, XL - 1)], 0.0)
        g = r0 + np.arange(rows)
        g = g[g < n_rows]
        sums = np.zeros((slices, B, len(g)))
        live = g < nv
        for s in range(slices):
            for j in range(s, D, slices):
                k = g - r0 + hi - offsets[j]
                assert ((k >= 0) & (k < width)).all()
                read[np.clip(src[k][live & ok[k]], 0, XL - 1)] = True
                v = np.where(live, vd[j, np.clip(g, 0, nv - 1)], 0.0)
                sums[s] += v * xsh[:, k]
        total = sums[0]
        for s in range(1, slices):
            total = total + sums[s]
        out[:, g] = total if store else out[:, g] + total
    return out, read


def _unstaged_model(vals, x_flat, y, offsets, slices, store):
    """``sdia_gen_kernel``'s sums (x read from the planes, zero outside):
    the form before the staging, in the same order."""
    R, D = vals.shape[:2]
    nv = R * 1024
    vd = vals.transpose(1, 0, 2, 3).reshape(D, nv)
    B, XL = x_flat.shape
    out = y.copy()
    n_rows = y.shape[1] if store else min(y.shape[1], nv)
    rows = GEN_THREADS // slices
    for r0 in range(0, n_rows, rows):
        g = r0 + np.arange(rows)
        g = g[g < n_rows]
        sums = np.zeros((slices, B, len(g)))
        for s in range(slices):
            for j in range(s, D, slices):
                src = g - offsets[j]
                ok = (src >= 0) & (src < XL) & (g < nv)
                v = np.where(ok, vd[j, np.clip(g, 0, nv - 1)], 0.0)
                sums[s] += v * np.where(ok, x_flat[:, np.clip(src, 0,
                                                              XL - 1)], 0.0)
        total = sums[0]
        for s in range(1, slices):
            total = total + sums[s]
        out[:, g] = total if store else out[:, g] + total
    return out


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("slices", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [8, 11])
@pytest.mark.parametrize("name", ["band", "holes"])
def test_sdia_gen_staged_model_matches_twin(name, B, slices, store,
                                            monkeypatch):
    """B12 f64's staged window as the numpy model, adding and storing at
    1, 2, 4 and 8 slices, from X read in place (x_len = the shard's rows):
    every diagonal's x lies in its CTA's window, no row outside x is read
    (those read 0), the sums are the unstaged kernel's at the same slices
    bit for bit and the twin's within 1e-12 of |A| |X|; absent rows come
    out exact 0 when storing."""
    sh, g0 = _mirrored_shard(name, monkeypatch)
    vals = sh.dia_vals.numpy()
    offs = sh.dia_offsets.tolist()
    window = sh.dia_window
    assert window == sk.gen_window(offs) == (max(offs), max(offs) - min(offs))
    m = sh.nrows
    T = sh.num_row_tiles + 1
    rng = np.random.default_rng(70 + B)
    X = rng.uniform(10.01, 20.42, (m, B))
    y0 = rng.uniform(-1, 1, (B, T * 128))
    got, read = _staged_model(vals, X.T.copy(), y0, offs, slices, store,
                              window)
    assert read.any()
    before = _unstaged_model(vals, X.T.copy(), y0, offs, slices, store)
    assert np.array_equal(got, before)
    x3d = ops.pad_x_mm(torch.from_numpy(X), sh.x_rows)
    y3 = torch.from_numpy(y0.reshape(B, T, 128).copy())
    want = sk.sdia_gen_tiles_mm_plain(sh.dia_vals, x3d, y3.clone(),
                                      sh.dia_offsets, store=store).numpy()
    scale = sk.sdia_gen_tiles_mm_plain(
        sh.dia_vals.abs(), x3d, y3.abs(), sh.dia_offsets).numpy()
    got = got.reshape(B, T, 128)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(scale, 1e-300)).all()
    if name == "holes":
        lo, hi = max(1100 - g0, 0), min(3000 - g0, m)
        assert lo < hi
        if store:
            assert not got.reshape(B, -1)[:, lo:hi].any()


@pytest.mark.parametrize("offsets,window", [
    (list(range(-32, 0)) + list(range(1, 33)), (32, 64)),  # cant mirrored
    ([-6, -1, 0, 1, 6], (6, 12)),
    ([-64, 64], (64, 128)),
    ([-65, 64], None),  # past GEN_SPAN
    ([-6400, -80, -1, 0, 1, 80, 6400], None),  # general_asym()
    ([3, 5], (5, 2)),
    ([], None)])
def test_gen_window_rule(offsets, window):
    """The double kernel stages where the offsets span at most GEN_SPAN
    (128): a banded shard's mirrored diagonals, not general_asym()'s."""
    assert sk.GEN_SPAN == 128
    assert sk.gen_window(offsets) == window


def test_upload_sets_dia_window(monkeypatch):
    """The float64 operator's mirrored shards carry their offsets' window
    from upload; unmirrored shards carry none."""
    sh, _ = _mirrored_shard("band", monkeypatch)
    assert sh.dia_window == sk.gen_window(sh.dia_offsets.tolist())
    monkeypatch.delenv("CFS_DIST_SDIA_ROWS_MAX")
    port = DistSpDMV(port_csr(_band(4096, 6, 7)), make_mesh(8, device="cpu"),
                     dia_min_count=8, dtype=np.float64)
    near = port.shards[3].near
    assert not near.dia_mirrored and near.dia_window is None


@pytest.mark.parametrize("rows,D,slices", [
    (16_384, 64, 4), (16_384, 16, 4), (16_384, 12, 2), (16_384, 7, 1),
    (67_584, 64, 4), (67_585, 64, 2), (135_168, 64, 2), (270_336, 64, 1)])
def test_stage_slices_rule(rows, D, slices):
    """4 or 2 threads a row where they fit the card (132 x 2048 thread
    slots on an H100) with 4 diagonals a thread or more, else 1: 4 on
    D1's mirrored shard (16,384 rows, 64 diagonals)."""
    assert sk.stage_slices(rows, D) == slices


# -- the wrappers' plane groups and staging arguments ----------------------


@contextlib.contextmanager
def _recorded(monkeypatch, module):
    """Run a wrapper's launcher on CPU tensors with the C entry point
    replaced by a recorder of its arguments."""
    calls = []

    def entry(name, dtype):
        return lambda *a: calls.append(a) or 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(module._cuda, "entry", entry)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    yield calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,groups", [(1, [1]), (8, [8]), (11, [8, 3]),
                                      (16, [8, 8])])
def test_sbell_plane_groups(B, groups, dtype, monkeypatch):
    """The paired wrapper's launches: one a group of up to 8 planes in
    double as in float32 (B = 8 one launch, 11 two), each after its own
    zero pass (the launcher's), the planes' pointers at the group's
    first plane."""
    assert _cuda.RHS_GROUP == GROUP
    C = 4
    vals = torch.zeros((C * 8, 128), dtype=dtype)
    packed = torch.zeros((C * 8, 128), dtype=torch.int32)
    meta = torch.zeros((C, 10), dtype=torch.int32)
    sb = torch.zeros(1, dtype=torch.int32)
    x3 = torch.zeros((B, 6, 128), dtype=dtype)
    y3 = torch.zeros((B, 8, 128), dtype=dtype)
    with _recorded(monkeypatch, bk) as calls:
        n = bk._launch_sbell(vals, packed, meta, sb, x3, y3, 4, 8, 2, "t")
    assert n == len(groups) == len(calls)
    assert [c[-2] for c in calls] == groups
    ys = y3.stride(0) * y3.element_size()
    assert [c[-4] - y3.data_ptr() for c in calls] == [
        i * GROUP * ys for i in range(len(groups))]


@pytest.mark.parametrize("dtype,staged", [(torch.float64, True),
                                          (torch.float64, False),
                                          (torch.float32, True)])
@pytest.mark.parametrize("B,groups", [(1, [1]), (8, [8]), (11, [8, 3])])
def test_sdia_gen_plane_groups_and_window(B, groups, dtype, staged,
                                          monkeypatch):
    """The signed diagonal wrappers' launches: one a group of up to 8
    planes; a float64 stream with the plan's window passes its (hi, span)
    and the staged slices rule's count, anything else span -1 (float32
    values never stage) and gen_slices' count."""
    offs = list(range(-6, 0)) + list(range(1, 7))
    window = sk.gen_window(offs) if staged else None
    vals = torch.zeros((1, len(offs), 8, 128), dtype=dtype)
    offsets = torch.tensor(offs, dtype=torch.int32)
    x_il = torch.zeros((B, 1024), dtype=dtype)
    y3 = torch.zeros((B, 8, 128), dtype=dtype)
    monkeypatch.setattr(sk, "_thread_slots", lambda device: sk.H100_THREAD_SLOTS)
    with _recorded(monkeypatch, sk) as calls:
        n = sk._launch_gen(vals, x_il, y3, offsets, "t", window=window)
    assert n == len(groups) == len(calls)
    assert [c[-2] for c in calls] == groups
    hi, span = (6, 12) if staged and dtype == torch.float64 else (0, -1)
    rule = sk.stage_slices if span >= 0 else sk.gen_slices
    for c in calls:
        assert c[8:10] == (hi, span)
        assert c[6] == rule(1024, len(offs))
