"""The solvers over a ``DistSpDMV`` across several cards, and the
operator's spans and counter, on the CPU.

A mesh over several cards is stood in for by a mesh of four distinct CPU
devices (``cpu:0`` ... ``cpu:3``, whose tensors all live on the CPU),
which runs the apply across cards eagerly. The matrix
is HPCG's 27-point stencil (``spmv_bench/generators/hpcg27.py``) at 16^3
in float64, in four shards with the halo exchange; the plain float64 CG
it is held to is the benchmark's reference (``spmv_bench/reference.py``).
"""

import numpy as np
import pytest
import torch

from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.models import solvers
from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
from cfs_spmv_tpu_torch.parallel.mesh import Mesh, make_mesh
from cfs_spmv_tpu_torch.utils import trace
from spmv_bench import matrices
from spmv_bench.reference import Reference

#: HPCG's problem at 16^3: 4,096 rows, four shards of 1,024
GRID = {"generator": "hpcg27", "nx": 16, "ny": 16, "nz": 16}
#: a mesh of four distinct devices, every tensor of which is on the CPU
CARDS = Mesh(tuple(torch.device("cpu", i) for i in range(4)))


@pytest.fixture(scope="module")
def mat():
    return matrices.make(GRID)


def _dist(mat, mesh=None, **kw):
    csr = CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
              symmetric=True)
    return DistSpDMV(csr, mesh or make_mesh(4, device="cpu"),
                     dtype=np.float64, comm="halo", **kw)


def _b(mat, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(mat.n, generator=g, dtype=torch.float64) * 2 - 1
    return Reference(mat, "cpu").matvec(x)


@pytest.mark.parametrize("mesh, capturable", [
    ("one device", True),
    ("several cards", False),
    ("process group", True),
])
def test_the_operator_says_whether_a_graph_holds_it(mat, monkeypatch, mesh,
                                                    capturable):
    """``capturable`` is False only across several cards of one process;
    ``_Operator`` on the card graphs exactly where it is True, and keeps
    the loop free of host syncs either way."""
    meshes = {"one device": None, "several cards": CARDS,
              "process group": Mesh((torch.device("cpu"),) * 4,
                                    group=object(), rank=1)}
    op = _dist(mat, meshes[mesh])
    assert op.capturable is capturable
    monkeypatch.setattr(solvers, "operator_space",
                        lambda m, like=None: (torch.float64,
                                              torch.device("cuda", 0)))
    o = solvers._Operator(op, "graph")
    assert o.graphed is capturable and o.sync_free is True
    assert solvers._Operator(op, "eager").sync_free is False
    # a bare callable has no say: graphed on the card
    assert solvers._Operator(lambda v: v, "graph").graphed is True


def test_cg_across_cards_matches_a_plain_cg(mat):
    op = _dist(mat, CARDS)
    assert not op.capturable and op.comm == "halo"
    b = _b(mat)
    x = solvers.cg(op, b, iters=50)[0]
    x_ref = Reference(mat, "cpu").cg(b, 50)
    err = torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(
        x_ref)
    assert err <= 1e-10


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_solvers_across_cards_are_bit_identical_to_one_device(mat, solver):
    b = _b(mat, seed=5)
    kw = {"iters": 20} if solver == "cg" else {"restart": 8, "outer": 3}
    run = getattr(solvers, solver)
    one = run(_dist(mat), b, **kw)
    op = _dist(mat, CARDS)
    cards = run(op, b, **kw)
    assert op._bufs
    for a, c in zip(one, cards):
        assert torch.equal(a, c)


def _recorded(fn):
    trace.collect()
    with trace.recording():
        out = fn()
    return out, trace.collect()


@pytest.mark.parametrize("rhs", [1, 3])
def test_an_apply_is_one_root_over_its_steps(mat, rhs):
    op = _dist(mat, CARDS)
    x = torch.ones((mat.n,) if rhs == 1 else (mat.n, rhs),
                   dtype=torch.float64)
    y, rec = _recorded(lambda: op(x))
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "cfs.dist.apply"
    assert root.attrs == {"rhs": rhs, "comm": "halo", "cards": 4}
    under = rec.descendants(root)
    assert len(under) == len(rec.spans) - 1
    names = [s.name for s in under]
    assert names.count("cfs.dist.scatter") == 1
    assert names.count("cfs.dist.gather") == 1
    shards = [s for s in under if s.name == "cfs.dist.shard"]
    assert [(s.attrs["shard"], s.attrs["device"]) for s in shards] == [
        (d, f"cpu:{d}") for d in range(4)]
    exchanges = [s for s in under if s.name == "cfs.dist.exchange"]
    assert len(exchanges) == 4  # every shard's halo window is filled
    assert {s.attrs["comm"] for s in exchanges} == {"halo"}
    by_id = {s.id: s for s in rec.spans}
    # across cards every window is filled by the scatter, before any
    # shard's kernels
    assert {by_id[s.parent].name for s in exchanges} == {"cfs.dist.scatter"}
    assert torch.equal(y, _dist(mat)(x))  # the steps change no answer


def test_the_construction_is_one_root_over_plan_and_upload(mat):
    _, rec = _recorded(lambda: _dist(mat, CARDS))
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "cfs.dist.build"
    assert root.attrs == {"nrows": 4096, "shards": 4}
    assert [s.name for s in rec.children(root)] == ["cfs.dist.plan",
                                                    "cfs.dist.upload"]


@pytest.mark.parametrize("rhs", [1, 2])
def test_copy_bytes_are_the_hand_count(mat, rhs):
    """Across four cards with the halo exchange, an apply copies shards
    1-3's x segments out (1,024 rows each), their neighbours' 256-row
    halos with them (5 of them: one z-plane each; shard 0's right halo
    is filled on card 0, from x) and shards 1-3's y rows back, in float64
    x ``rhs``."""
    op = _dist(mat, CARDS)
    assert op.shard_rows == 1024 and op.halo_rows == 256
    assert op.real == [(0, 1024), (1024, 1024), (2048, 1024), (3072, 1024)]
    x = torch.ones((mat.n,) if rhs == 1 else (mat.n, rhs),
                   dtype=torch.float64)
    _, rec = _recorded(lambda: op(x))
    assert rec.counters["dist.copy_bytes"] == (
        (3 * 1024 + 5 * 256 + 3 * 1024) * 8 * rhs)
    # a CG solve applies the operator once a iteration and once for its
    # first residual
    _, rec = _recorded(lambda: solvers.cg(op, _b(mat), iters=4))
    assert rec.counters["dist.copy_bytes"] == 5 * (3 * 1024 + 5 * 256
                                                   + 3 * 1024) * 8


@pytest.mark.parametrize("mesh", ["one device", "process group"])
def test_no_copy_bytes_without_a_second_card(mat, mesh):
    group = object() if mesh == "process group" else None
    op = _dist(mat, Mesh((torch.device("cpu"),) * 4, group=group, rank=0))
    if group is not None:  # the all-gather needs the group: the own rows
        op._all_gather = lambda y: y
    _, rec = _recorded(lambda: op(torch.ones(mat.n, dtype=torch.float64)))
    assert len(rec.named("cfs.dist.apply")) == 1
    assert rec.counters.get("dist.copy_bytes", 0) == 0
