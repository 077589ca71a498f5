"""deal.II step-8's elasticity matrix on the card, at 32^3 cells (107,811
rows): the card's assembly gives the CPU's matrix bit for bit, the
entry-list plan's entries made on the card are the CPU's, and the cell
``elast128-spmv``'s path (``SpDMV`` in float64 over the entry-list plan,
which ``tune`` takes past ``FP64_ENTRIES_MIN_NNZ``, lowered here to this
size: B15 on entries, then B13 over the peel's planes) holds to the
configuration's plain reference (``spmv_bench/references/
q1_elasticity.py``, run on the card) at B = 1 and 8.

Runs only where there is a CUDA card; on the card's machine without
``tests/conftest.py``, which sets up the JAX reference:

    python -m pytest --noconftest -m card tests/test_torch_elasticity_card.py

The CPU tests of the same path are in ``tests/test_torch_elasticity.py``.
"""

import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.tuning import tune as tn
from cfs_spmv_tpu_torch.utils import trace
from spmv_bench import matrices, reference, spec
from spmv_bench.generators import q1_elasticity as q1

REFINE = 5


@pytest.fixture
def card():
    """A CUDA card, else the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def cfg():
    bench = spec.load_benchmark()
    found = spec.config(bench, spec.cell(bench, "elast128-spmv")["config"])
    return {**found, "refine": REFINE}


@pytest.mark.card
def test_the_card_assembles_the_cpus_matrix(card, cfg):
    on_card = q1.make(cfg, device=card)
    on_cpu = q1.make(cfg, device="cpu")
    assert on_card[0] == on_cpu[0] == 3 * (2**REFINE + 1) ** 3
    for a, b in zip(on_card[1:], on_cpu[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.card
def test_the_card_makes_the_cpus_entries(card, cfg):
    mat = matrices.make(cfg)
    plan = tn.build_fp64_plan(ct.CSR(mat.n, mat.n, mat.indptr, mat.indices,
                                     mat.data, symmetric=True), entries=True)
    assert plan.dia is not None and plan.nnz > 0
    args = (plan.row, plan.col, plan.val, plan.nrows)
    got, want = bk.lower_entries(*args, card), bk.lower_entries(*args, "cpu")
    assert (got.min_tiles, got.min_x_rows) == (want.min_tiles,
                                               want.min_x_rows)
    for f in ("rows", "cols", "vals"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))


@pytest.mark.card
@pytest.mark.parametrize("rhs", [1, 8])
def test_the_cells_path_holds_to_the_reference(card, cfg, rhs,
                                               monkeypatch):
    monkeypatch.setattr(tn, "FP64_ENTRIES_MIN_NNZ", 0)
    mat = matrices.make(cfg)
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    opts = dict(cfg["tune"])
    fmt, tuning = ct.Format[opts.pop("format")], ct.Tuning[opts.pop("tuning")]
    with trace.recording():
        op = ct.SpDMV(ct.SparseMatrix.create(csr, fmt), tuning,
                      dtype=np.float64, device=card, cache_dir="", **opts)
        g = torch.Generator(device=card).manual_seed(rhs)
        x = torch.rand((mat.n,) if rhs == 1 else (mat.n, rhs), generator=g,
                       dtype=torch.float64, device=card) * 2 - 1
        y = op(x)
        torch.cuda.synchronize(card)
    rec = trace.collect()
    assert rec.named("cfs.tune")[0].attrs["fp64_stream"] == "entries"
    assert rec.counters["fp64.stream_entries"] == 1
    ref = spec.reference(cfg["reference"])(mat, card)
    err = reference.apply_error(y, ref.matvec(x), ref.matvec(x, absolute=True))
    assert err < 1e-14 <= cfg["limits"]["apply_err"]
