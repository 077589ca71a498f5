"""The Graph500 Kronecker graph on the card, at SCALE 18 (262,144 vertices,
4,194,304 edges drawn): the card's draws give the CPU's matrix bit for
bit, and the cell ``kron-spmv``'s path (``SpDMV`` in float32 over the
symmetric plan, RCM left to ``"auto"``) holds to the benchmark's plain
reference (``spmv_bench/reference.py``) within the configuration's
``apply_err`` limit, with the far stream's kernels run and counted
(``sbell.far_grouped``, ``sbell.far_entries`` or ``sbell.far_rows``); the
upload's decoding of the far stream's chunk grid into its entries
(``bell2_kernel.compact_stream``) gives on the card the CPU's entries, in
the same order.

B4 rows (``bell2_kernel.bell2_entries_rows``, the one pass y = D x + R x
over the far stream's entries that the cell runs) on the plan without the
relaxed search: against its twin, the float64 oracle and the parent's
composition (padded x, the seed D x, B4), repeating bit for bit, into a
NaN-poisoned buffer (an unwritten row shows), on the star graph of
``tests/test_torch_kron_rows.py`` (a hub row over several slices) and on an
8-tile-block replan with a range of empty rows.

Runs only where there is a CUDA card; on the card's machine without
``tests/conftest.py``, which sets up the JAX reference:

    python -m pytest --noconftest -m card tests/test_torch_kron_card.py

The CPU tests of the same path are in ``tests/test_torch_kron.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import spmv
from cfs_spmv_tpu_torch.utils import trace
from spmv_bench import matrices, reference, spec
from spmv_bench.generators import graph500_kron as kron
from test_torch_kron_rows import _close, _star, _sym_entries, _with_empty_rows

SCALE = 18


@pytest.fixture
def card():
    """A CUDA card, else the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cfg():
    bench = spec.load_benchmark()
    found = spec.config(bench, spec.cell(bench, "kron-spmv")["config"])
    return {**found, "scale": SCALE}


@pytest.mark.card
def test_the_card_draws_the_cpus_matrix(card, cfg):
    on_card = kron.make(cfg, device=card)
    on_cpu = kron.make(cfg, device="cpu")
    assert on_card[0] == on_cpu[0] == 2**SCALE
    for a, b in zip(on_card[1:], on_cpu[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("rhs", [1, 8])
def test_the_cells_path_holds_to_the_reference(card, cfg, rhs):
    mat = matrices.make(cfg)
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    opts = dict(cfg["tune"])
    fmt, tuning = ct.Format[opts.pop("format")], ct.Tuning[opts.pop("tuning")]
    with trace.recording():
        op = ct.SpDMV(ct.SparseMatrix.create(csr, fmt), tuning,
                      dtype=np.float32, device=card, cache_dir="", **opts)
        g = torch.Generator(device=card).manual_seed(rhs)
        shape = (mat.n,) if rhs == 1 else (mat.n, rhs)
        x = torch.rand(shape, generator=g, device=card) * 2 - 1
        y = op(x)
        torch.cuda.synchronize()
    rec = trace.collect()
    assert rec.counters["tune.fp32_far_nnz"] > 0.9 * rec.counters[
        "tune.fp32_nnz"]
    assert sum(rec.counters.get(f"sbell.far_{form}", 0)
               for form in ("grouped", "entries", "rows")) == 1
    del op
    ref = reference.Reference(mat, card)
    err = reference.apply_error(y, ref.matvec(x),
                                ref.matvec(x, absolute=True))
    assert err <= cfg["limits"]["apply_err"]


@pytest.mark.card
def test_the_card_compacts_the_cpus_entries(card, cfg):
    mat = matrices.make(cfg)
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    far = build_sbell_plan(csr, dtype=np.float32, allow_relax=False).far
    assert far.row_perm is None and far.sparse_stream
    kw = dict(chunks_per_step=far.chunks_per_step,
              tiles_per_block=far.tiles_per_block,
              contig=far.windows_contig or far.window_depth > 8,
              num_row_tiles=far.num_row_tiles, x_rows=far.x_rows)
    grid = (far.vals, far.packed, far.meta, far.step_block)
    on_card = bk.compact_stream(*grid, **kw, device=card)
    on_cpu = bk.compact_stream(*grid, **kw)
    assert on_card.count == on_cpu.count == far.nnz
    assert on_card.rows.device.type == "cuda"
    for name in ("rows", "cols", "vals"):
        assert torch.equal(getattr(on_card, name).cpu(),
                           getattr(on_cpu, name)), name
    assert (on_card.min_tiles, on_card.min_x_rows) == (on_cpu.min_tiles,
                                                       on_cpu.min_x_rows)


def _rows_plan(mat, card, **kw):
    """``mat``'s symmetric float32 plan without the relaxed search, on the
    card: its far stream is entries, the pass B4 rows."""
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    dev = spmv.sym_to_device(build_sbell_plan(
        csr, dtype=np.float32, allow_relax=False, **kw), card)
    assert dev.far_rows is not None
    return dev


def _x(n, card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.rand(n, generator=g, device=card) * 2 - 1


def _check_rows(es, er, diag, x):
    """The kernel into a NaN-poisoned buffer: every row written, the rows
    without entries d x exactly, the twin's and the oracle's result, the
    same bits again; returns y."""
    n = er.nrows
    launches = bk.bell2_entries_rows.launches
    buf = torch.full((n + 2 * er.slices,), float("nan"), device=x.device)
    y = bk.bell2_entries_rows(es, er, diag, x, out=buf)
    again = bk.bell2_entries_rows(es, er, diag, x)
    twin = bk.bell2_entries_rows_plain(es, er, diag, x)
    torch.cuda.synchronize()
    assert bk.bell2_entries_rows.launches - launches == 2
    assert not torch.isnan(y).any()
    assert torch.equal(y, again)
    empty = er.ptr.diff() == 0
    assert torch.equal(y[empty], (diag * x)[empty])
    for got in (y, twin):
        assert _close(got.cpu(), es.to("cpu"), diag.cpu(), x.cpu())
    return y


@pytest.mark.card
def test_b4_rows_holds_to_its_twin_and_the_parents_b4(card, cfg):
    dev = _rows_plan(matrices.make(cfg), card)
    x = _x(dev.nrows, card, 1)
    y = _check_rows(dev.far.entries, dev.far_rows, dev.diag, x)
    launches = bk.bell2_spmv_tiles_accum.launches
    parent = spmv.sbell_apply(dataclasses.replace(dev, far_rows=None), x)
    torch.cuda.synchronize()
    assert bk.bell2_spmv_tiles_accum.launches == launches + 1
    assert _close(parent.cpu(), dev.far.entries.to("cpu"), dev.diag.cpu(),
                  x.cpu())
    assert float((y - parent).abs().max()) < 1e-5
    with trace.recording():
        assert torch.equal(spmv.sbell_apply(dev, x), y)
    assert trace.collect().counters["sbell.far_rows"] == 1


@pytest.mark.card
def test_b4_rows_spreads_a_hub_row(card):
    n, rows, cols, vals, diag = _star()
    es, d = _sym_entries(n, rows, cols, vals, diag)
    es, d = es.to(card), d.to(card)
    er = bk.entry_rows(es, n)
    assert int(er.ptr[1]) > 4 * bk.ROWS_ITEMS
    _check_rows(es, er, d, _x(n, card, 2))


@pytest.mark.card
def test_b4_rows_on_an_eight_tile_block_replan_with_empty_rows(card, cfg):
    mat = _with_empty_rows(matrices.make(cfg), 10_000, 60_000)
    dev = _rows_plan(mat, card, tiles_per_block=8, dia=False)
    assert bool((dev.far_rows.ptr.diff()[10_000:60_000] == 0).all())
    _check_rows(dev.far.entries, dev.far_rows, dev.diag, _x(mat.n, card, 3))
