"""The Graph500 Kronecker graph on the card, at SCALE 18 (262,144 vertices,
4,194,304 edges drawn): the card's draws give the CPU's matrix bit for
bit, and the cell ``kron-spmv``'s path (``SpDMV`` in float32 over the
symmetric plan, RCM left to ``"auto"``) holds to the benchmark's plain
reference (``spmv_bench/reference.py``) within the configuration's
``apply_err`` limit, with the far stream's kernels run and counted
(``sbell.far_grouped`` or ``sbell.far_entries``); the upload's decoding
of the far stream's chunk grid into its entries
(``bell2_kernel.compact_stream``) gives on the card the CPU's entries, in
the same order.

Runs only where there is a CUDA card; on the card's machine without
``tests/conftest.py``, which sets up the JAX reference:

    python -m pytest --noconftest -m card tests/test_torch_kron_card.py

The CPU tests of the same path are in ``tests/test_torch_kron.py``.
"""

import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.utils import trace
from spmv_bench import matrices, reference, spec
from spmv_bench.generators import graph500_kron as kron

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
    assert (rec.counters.get("sbell.far_grouped", 0)
            + rec.counters.get("sbell.far_entries", 0)) == 1
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
