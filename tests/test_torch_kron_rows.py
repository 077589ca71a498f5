"""B4 rows (``ops/bell2_kernel.bell2_entries_rows``) on the CPU: the one
pass ``y = D x + R x`` that ``sbell_apply`` runs where a symmetric float32
plan's whole off-diagonal part is its far stream's entries, as in the cell
``kron-spmv``.

- ``entry_rows``: the row pointers against the entries' rows, and each
  slice's start on the merge path (the largest row i with ptr[i] + i at or
  before its first item), every slice of the same length.
- A numpy model of ``bell2_entries_kernel_rows`` and its carry pass as
  they ship (256 threads of 5 path items a CTA): each thread's binary search
  of the CTA's row ends, its walk, the segmented sum over the threads, the
  epilogue and the carries. It writes every row once, a row without
  entries reads ``d[r] x[r]`` exactly, and it agrees with the twin and the
  float64 oracle at ``allclose_spmv``.
- The twin against the benchmark's plain reference and the float64 oracle
  on a Kronecker graph (SCALE 10 and 11) past a lowered
  ``tune.RELAX_MAX_NNZ``, whose far stream is entries; against the parent
  composition (padded x, the seed D x, B4's twin) bit for bit.
- A star graph whose hub row spans several slices; an 8-tile-block replan
  with a range of empty rows.
- ``sbell_apply`` takes the pass only where the plan has neither a paired
  nor a diagonal stream, and counts ``sbell.far_rows`` (not
  ``sbell.far_entries``) an apply; SpMM keeps B8.

The card's half is in ``tests/test_torch_kron_card.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import spmv
from cfs_spmv_tpu_torch.tuning import tune as tn
from cfs_spmv_tpu_torch.utils import proxies
from cfs_spmv_tpu_torch.utils import trace
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
from spmv_bench import matrices, reference, spec

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg():
    bench = spec.load_benchmark()
    return spec.config(bench, spec.cell(bench, "kron-spmv")["config"])


def _csr(mat):
    return ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                  symmetric=True)


def _sym_entries(n, lower_rows, lower_cols, lower_vals, diag):
    """The symmetric matrix of a strict lower triangle and its diagonal as
    ``sym_to_device`` would give it: the off-diagonal entries of both
    triangles sorted by row (an :class:`EntryStream`), and the diagonal."""
    r = np.concatenate([lower_rows, lower_cols]).astype(np.int64)
    c = np.concatenate([lower_cols, lower_rows]).astype(np.int64)
    v = np.concatenate([lower_vals, lower_vals]).astype(np.float32)
    order = np.argsort(r, kind="stable")
    r, c, v = r[order], c[order], v[order]
    es = bk.EntryStream(
        rows=torch.from_numpy(r.astype(np.int32)),
        cols=torch.from_numpy(c.astype(np.int32)),
        vals=torch.from_numpy(v), min_tiles=-(-n // 128),
        min_x_rows=-(-n // 128))
    return es, torch.from_numpy(np.asarray(diag, np.float32))


def _star(n=8000, seed=3):
    """A hub (row 0) joined to every other vertex, and a sprinkle of edges
    among the others: the hub's row holds n - 1 entries, several slices
    of the kernel's 1,280 path items."""
    rng = np.random.default_rng(seed)
    i = np.arange(1, n)
    extra_r = rng.integers(2, n, n // 4)
    extra_c = rng.integers(1, n, n // 4) % extra_r
    keep = extra_c > 0
    rows = np.concatenate([i, extra_r[keep]])
    cols = np.concatenate([np.zeros(n - 1, np.int64), extra_c[keep]])
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.uniform(-1, 1, len(rows))
    diag = rng.uniform(1, 2, n)
    return n, rows, cols, vals, diag


def _oracle(es, diag, x):
    """y = D x + R x in float64, and its scale (|D| |x| + |R| |x|)."""
    xd = x.double()
    rows, cols = es.rows.long(), es.cols.long()
    y = diag.double() * xd
    y.index_add_(0, rows, es.vals.double() * xd[cols])
    s = diag.double().abs() * xd.abs()
    s.index_add_(0, rows, es.vals.double().abs() * xd[cols].abs())
    return y.numpy(), s.numpy()


def _close(y, es, diag, x):
    y64, scale = _oracle(es, diag, x)
    n = diag.shape[0]
    return allclose_spmv(np.asarray(y), y64, np.float32,
                         nnz_per_row=max(1.0, es.count / n), scale=scale)


def _x(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g, dtype=torch.float32) * 2 - 1


# ---------------------------------------------------------------------------
# the numpy model of the kernel and its carry pass

def _segmented(flags, vals, threads):
    """``cta_segmented_sum`` over the CTA's threads: the warps' shuffle
    steps (each lane from the old values), then the warps before, latest
    first. Returns (each thread's sum, the warps' last flags and sums)."""
    f32 = np.float32
    f, v = flags.copy(), vals.copy()
    for w0 in range(0, threads, 32):
        fw, vw = f[w0:w0 + 32], v[w0:w0 + 32]
        d = 1
        while d < 32:
            pf, pv = fw.copy(), vw.copy()
            for lane in range(d, 32):
                if not pf[lane]:
                    vw[lane] = f32(pv[lane - d] + pv[lane])
                fw[lane] = pf[lane] or pf[lane - d]
            d *= 2
    warp_f, warp_v = f[31::32].copy(), v[31::32].copy()
    out = v.copy()
    for t in range(threads):
        if f[t]:
            continue
        before = f32(0)
        for w in range(t // 32 - 1, -1, -1):
            before = f32(warp_v[w] + before)
            if warp_f[w]:
                break
        out[t] = f32(before + v[t])
    return out, warp_f, warp_v


def _model(es, er, diag, x, threads=256, ipt=5):
    """``bell2_entries_kernel_rows`` and its carry pass, CTA by CTA and
    thread by thread, in float32: (y with NaN where no CTA wrote, the
    writes each row got)."""
    f32 = np.float32
    assert bk.ROWS_ITEMS == threads * ipt
    ptr, tiles = er.ptr.numpy(), er.tiles.numpy()
    cols, vals = es.cols.numpy(), es.vals.numpy()
    d, xs, n, nb = diag.numpy(), x.numpy(), er.nrows, er.slices
    y = np.full(n, np.nan, f32)
    writes = np.zeros(n, np.int64)
    carry_row = np.zeros(nb, np.int64)
    carry_val = np.zeros(nb, f32)
    for b in range(nb):
        (i0, j0), (i1, j1) = tiles[b], tiles[b + 1]
        nrows, nent = i1 - i0, j1 - j0
        assert nrows + nent == bk.ROWS_ITEMS or b == nb - 1
        prod = (vals[j0:j1] * xs[cols[j0:j1]]).astype(f32)
        rend = ptr[i0 + 1:i1 + 1] - j0
        rsum = np.full(nrows, np.nan, f32)
        flags = np.zeros(threads, bool)
        runs = np.zeros(threads, f32)
        firsts, heads = np.full(threads, -1), np.zeros(threads, f32)
        for t in range(threads):
            k0 = t * ipt
            k1 = min(k0 + ipt, nrows + nent)
            lo, hi = max(0, k0 - nent), min(nrows, k0)
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if rend[mid - 1] + mid <= k0:
                    lo = mid
                else:
                    hi = mid - 1
            a, e, run = lo, k0 - lo, f32(0)
            for _ in range(k0, k1):
                if a < nrows and e >= rend[a]:
                    if firsts[t] < 0:
                        firsts[t], heads[t] = a, run
                    else:
                        rsum[a] = run
                    run = f32(0)
                    a += 1
                else:
                    run = f32(run + prod[e])
                    e += 1
            flags[t], runs[t] = firsts[t] >= 0, run
        open_, warp_f, warp_v = _segmented(flags, runs, threads)
        for t in range(threads):
            if firsts[t] < 0:
                continue
            if t % 32:
                carried = open_[t - 1]
            else:
                carried = f32(0)
                for w in range(t // 32 - 1, -1, -1):
                    carried = f32(warp_v[w] + carried)
                    if warp_f[w]:
                        break
            rsum[firsts[t]] = f32(carried + heads[t])
        carry_row[b], carry_val[b] = i1, open_[threads - 1]
        r = np.arange(i0, i1)
        y[r] = (d[r].astype(np.float64) * xs[r] + rsum).astype(f32)
        writes[r] += 1
    for b in range(nb):
        row = carry_row[b]
        if row >= n or (b > 0 and carry_row[b - 1] == row):
            continue
        s, k = carry_val[b], b + 1
        while k < nb and carry_row[k] == row:
            s = f32(s + carry_val[k])
            k += 1
        if s != 0:
            y[row] = f32(y[row] + s)
    return y, writes


@pytest.fixture(scope="module")
def kron_entries(cfg):
    """Scale 10's symmetric matrix as an entry list (both triangles), its
    diagonal and an x."""
    mat = matrices.make({**cfg, "scale": 10})
    rows = np.repeat(np.arange(mat.n), np.diff(mat.indptr))
    off = rows != mat.indices
    diag = np.zeros(mat.n, np.float32)
    diag[rows[~off]] = mat.data[~off]
    es, d = _sym_entries(mat.n, rows[off], mat.indices[off], mat.data[off],
                         diag)
    return es, d, _x(mat.n, 1)


# ---------------------------------------------------------------------------
# entry_rows

def test_entry_rows_are_the_pointers_and_the_merge_path(kron_entries):
    es, d, _ = kron_entries
    n = d.shape[0]
    items = bk.ROWS_ITEMS
    er = bk.entry_rows(es, n)
    ptr, tiles = er.ptr.numpy(), er.tiles.numpy()
    assert er.ptr.dtype == er.tiles.dtype == torch.int32
    assert np.array_equal(
        ptr, np.concatenate([[0], np.cumsum(np.bincount(
            es.rows.numpy(), minlength=n))]))
    L = n + es.count
    assert er.slices == -(-L // items) > 10
    assert tuple(tiles[0]) == (0, 0) and tuple(tiles[-1]) == (n, es.count)
    k = tiles.sum(1)
    assert np.array_equal(k[:-1], np.arange(er.slices) * items)
    i, j = tiles[:, 0], tiles[:, 1]
    # on the path: the rows before i closed by entry j, row i not yet
    assert np.all(ptr[i] <= j)
    inner = i < n
    assert np.all(j[inner] <= ptr[i[inner] + 1])
    # the largest such row: the next row's start lies past the item
    nxt = i[inner] + 1
    assert np.all(ptr[nxt] + nxt > k[inner])


def test_entry_rows_refuses_entries_outside_the_rows(kron_entries):
    es, d, _ = kron_entries
    n = d.shape[0]
    with pytest.raises(ValueError, match="outside"):
        bk.entry_rows(es, n - 1)
    bad = dataclasses.replace(es, cols=es.cols.clone())
    bad.cols[5] = n
    with pytest.raises(ValueError, match="outside"):
        bk.entry_rows(bad, n)


def test_no_entries_gives_the_diagonal_term():
    n = 300
    empty = bk.EntryStream(rows=torch.zeros(0, dtype=torch.int32),
                           cols=torch.zeros(0, dtype=torch.int32),
                           vals=torch.zeros(0), min_tiles=0, min_x_rows=0)
    d, x = _x(n, 2) + 2, _x(n, 3)
    er = bk.entry_rows(empty, n)
    assert er.slices == 1 and tuple(er.tiles[-1].tolist()) == (n, 0)
    assert torch.equal(bk.bell2_entries_rows(empty, er, d, x), d * x)
    y, writes = _model(empty, er, d, x)
    assert np.all(writes == 1) and np.array_equal(y, (d * x).numpy())


# ---------------------------------------------------------------------------
# the model of the kernel

def test_the_kernels_walk_writes_every_row_once(kron_entries):
    es, d, x = kron_entries
    er = bk.entry_rows(es, d.shape[0])
    y, writes = _model(es, er, d, x)
    assert np.all(writes == 1)
    assert not np.isnan(y).any()
    empty = np.diff(er.ptr.numpy()) == 0
    assert empty.sum() > 0.05 * len(empty)  # isolated vertices
    assert np.array_equal(y[empty], (d * x).numpy()[empty])
    assert _close(y, es, d, x)
    twin = bk.bell2_entries_rows_plain(es, er, d, x)
    assert _close(twin, es, d, x)
    assert np.allclose(y, twin.numpy(), rtol=0, atol=1e-5)


def test_a_hub_row_spreads_over_slices():
    n, rows, cols, vals, diag = _star()
    es, d = _sym_entries(n, rows, cols, vals, diag)
    x = _x(n, 4)
    er = bk.entry_rows(es, n)
    hub = int(er.ptr[1])
    assert hub == n - 1 and hub > 4 * bk.ROWS_ITEMS
    # the hub's row is cut across several slices
    starts = er.tiles[:, 0].numpy()
    assert np.count_nonzero(starts == 0) >= 4
    y, writes = _model(es, er, d, x)
    assert np.all(writes == 1)
    assert _close(y, es, d, x)
    twin = bk.bell2_entries_rows(es, er, d, x)
    assert _close(twin, es, d, x)
    assert np.allclose(y, twin.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the applier

def _entries_plan(mat, monkeypatch, **kw):
    """The float32 symmetric tune of ``mat`` past a lowered relax ceiling:
    its far stream reaches the device as entries."""
    monkeypatch.setattr(tn, "RELAX_MAX_NNZ", mat.stored_nnz - 1)
    return tn.tune(_csr(mat), dtype=np.float32, device="cpu",
                   cache_dir="", **kw)


def _inner(tuned):
    ops = tuned.operands
    return ops["dev"] if isinstance(ops, dict) else ops


@pytest.mark.parametrize("scale", [10, 11])
@pytest.mark.parametrize("reorder", ["auto", False])
def test_the_twin_holds_to_the_reference_past_the_relax_ceiling(
        cfg, monkeypatch, scale, reorder):
    mat = matrices.make({**cfg, "scale": scale})
    tuned = _entries_plan(mat, monkeypatch, reorder=reorder)
    dev = _inner(tuned)
    assert dev.far_rows is not None and not dev.has_paired
    assert dev.dia_vals is None
    ref = reference.Reference(mat, "cpu")
    x = _x(mat.n, scale)
    with trace.recording():
        y = tuned.matvec(x)
    rec = trace.collect()
    assert rec.counters["sbell.far_rows"] == 1
    assert "sbell.far_entries" not in rec.counters
    err = reference.apply_error(y, ref.matvec(x), ref.matvec(x, absolute=True))
    assert err <= cfg["limits"]["apply_err"] and err < 1e-6
    # the float64 oracle, in the plan's row order
    xp = x if tuned.perm is None else x[torch.as_tensor(tuned.perm)]
    yp = spmv.sbell_apply(dev, xp)
    assert _close(yp, dev.far.entries, dev.diag, xp)
    # the parent composition (padded x, the seed D x, B4's twin): the same
    # additions in the same order
    parent = spmv.sbell_apply(dataclasses.replace(dev, far_rows=None), xp)
    assert torch.equal(yp, parent)


def _with_empty_rows(mat, lo, hi):
    """``mat`` without the off-diagonal entries of rows and columns lo..hi
    (their diagonal kept): a range of rows with no entry."""
    rows = np.repeat(np.arange(mat.n), np.diff(mat.indptr))
    c = mat.indices
    drop = (rows != c) & (((rows >= lo) & (rows < hi))
                          | ((c >= lo) & (c < hi)))
    keep = ~drop
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[keep], minlength=mat.n))]).astype(np.int64)
    return matrices.Matrix(mat.n, indptr, c[keep], mat.data[keep])


def test_an_eight_tile_block_replan_with_empty_rows(cfg):
    mat = _with_empty_rows(matrices.make({**cfg, "scale": 11}), 300, 1500)
    plan = build_sbell_plan(_csr(mat), tiles_per_block=8, dia=False,
                            allow_relax=False)
    dev = spmv.sym_to_device(plan, "cpu")
    assert dev.far_rows is not None and plan.far.tiles_per_block == 8
    es, er = dev.far.entries, dev.far_rows
    empty = er.ptr.diff() == 0
    assert bool(empty[300:1500].all())
    x = _x(mat.n, 5)
    y = spmv.sbell_apply(dev, x)
    assert torch.equal(y[empty], (dev.diag * x)[empty])
    assert _close(y, es, dev.diag, x)
    ym, writes = _model(es, er, dev.diag, x)
    assert np.all(writes == 1) and _close(ym, es, dev.diag, x)
    ref = reference.Reference(mat, "cpu")
    assert reference.apply_error(y, ref.matvec(x),
                                 ref.matvec(x, absolute=True)) < 1e-6


def _banded_and_scattered(n=2000):
    base = proxies.near_band_paired(n=n, n_diags=16, max_off=200,
                                    seed=5).to_coo()
    far = proxies.audikw_proxy(nb=667).to_coo()
    keep = (far.row < n) & (far.col < n)
    return ct.CSR.from_coo(ct.COO(
        n, n, np.concatenate([base.row, far.row[keep]]),
        np.concatenate([base.col, far.col[keep]]),
        np.concatenate([base.val, far.val[keep]]),
        symmetric=True).canonicalize())


@pytest.mark.parametrize("paired,dia,rows", [
    ("force", False, False),  # a paired stream: B5, then B4 into its tiles
    ("off", True, False),     # a diagonal stream: B4 into the seed, SDIA
    ("off", False, True),     # the far stream's entries alone
])
def test_the_pass_runs_only_without_paired_or_diagonal_streams(
        monkeypatch, paired, dia, rows):
    monkeypatch.setenv("CFS_PAIRED", paired)
    csr = _banded_and_scattered()
    plan = build_sbell_plan(csr, allow_relax=False, dia=dia)
    dev = spmv.sym_to_device(plan, "cpu")
    assert dev.far is not None and dev.far.entries is not None
    assert dev.has_paired is (paired == "force")
    assert (dev.dia_vals is not None) is dia
    assert (dev.far_rows is not None) is rows
    x = _x(csr.nrows, 6)
    with trace.recording():
        y = spmv.sbell_apply(dev, x)
        Y = spmv.sbell_apply_mm(dev, torch.stack([x, -x], 1))
    counters = trace.collect().counters
    assert counters.get("sbell.far_rows", 0) == int(rows)
    assert counters["sbell.far_entries"] == 2 - rows  # SpMM runs B8
    xd = x.numpy().astype(np.float64)
    scale = csr.spmv_host(xd, absolute=True)
    y64 = csr.spmv_host(xd)
    nnz = csr.nnz * 2 / csr.nrows
    for got in (y, Y[:, 0], -Y[:, 1]):
        assert allclose_spmv(got.numpy(), y64, np.float32, nnz_per_row=nnz,
                             scale=scale)
