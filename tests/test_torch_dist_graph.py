"""``DistSpDMV`` across several cards of one process: the apply over the
buffers the operator owns (``_Buffers``), and, on a node of two or more
cards, its captured form replayed.

On the CPU a mesh of distinct devices (``cpu:0`` ... ``cpu:P-1``, whose
tensors all live on the CPU) runs the apply eagerly: its y is held bit
for bit to the one-device mesh's over the same plans, and its counter
``dist.copy_bytes`` to the rows the schedule copies. The tests marked
``card`` skip without two CUDA cards; on the card's machine run them
without ``tests/conftest.py``, which sets up the JAX reference:

    python -m pytest --noconftest -m card tests/test_torch_dist_graph.py

The matrix is HPCG's 27-point stencil (``spmv_bench/generators/hpcg27.py``)
in float64; the plain float64 CG it is held to is the benchmark's
reference (``spmv_bench/reference.py``).
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

#: 4,096 rows in whole shards; 3,328 rows, whose last shard is short
GRIDS = {"even": (16, 16, 16), "uneven": (16, 16, 13)}


def _mat(grid):
    nx, ny, nz = GRIDS[grid]
    return matrices.make({"generator": "hpcg27", "nx": nx, "ny": ny,
                          "nz": nz})


def _csr(mat, symmetric=True):
    """The lower triangle as SSS, or the whole matrix as a general one."""
    if symmetric:
        return CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                   symmetric=True)
    rows = np.repeat(np.arange(mat.n), np.diff(mat.indptr))
    off = rows != mat.indices
    r = np.concatenate([rows, mat.indices[off]])
    c = np.concatenate([mat.indices, rows[off]])
    v = np.concatenate([mat.data, mat.data[off]])
    order = np.lexsort((c, r))
    indptr = np.concatenate([[0],
                             np.cumsum(np.bincount(r, minlength=mat.n))])
    return CSR(mat.n, mat.n, indptr, c[order].astype(np.int32), v[order],
               symmetric=False)


def _cards(p):
    """A mesh of ``p`` distinct devices, every tensor of which is on the
    CPU."""
    return Mesh(tuple(torch.device("cpu", i) for i in range(p)))


def _x(n, rhs, seed=11):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if rhs == 1 else (n, rhs)
    return torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1


def _schedule_bytes(op, rhs):
    """The bytes that the schedule copies between two different cards in
    one apply, counted from the partition: each shard's fills from x on
    the first card (halo: its window's real rows; gather: its rows and
    the whole x where its far stream runs; ring: its rows and those of
    every step whose stream runs) and its rows of y back."""
    S, H, P = op.shard_rows, op.halo_rows, op.ndev
    nr = [n for _, n in op.real]
    rows = 0
    for d in range(1, P):
        rows += 2 * nr[d]
        if op.comm == "halo":
            rows += max(0, nr[d - 1] - (S - H))
            rows += min(H, nr[d + 1]) if d + 1 < P else 0
        elif op.comm == "gather":
            rows += op.nrows if op.shards[d].far.has_work else 0
        else:
            rows += sum(nr[(d + k) % P] for k in range(1, P)
                        if op.shards[d].ring[k].has_work)
    return rows * 8 * rhs


#: (shards, grid): two to four shards, whole and short last shards
LAYOUTS = [(2, "even"), (3, "uneven"), (4, "even"), (4, "uneven")]


@pytest.mark.parametrize("comm", ["halo", "gather", "ring"])
@pytest.mark.parametrize("rhs", [1, 8])
@pytest.mark.parametrize("shards, grid", LAYOUTS)
def test_distinct_devices_give_the_one_device_y_bit_for_bit(comm, rhs, shards,
                                                            grid):
    mat = _mat(grid)
    one = DistSpDMV(_csr(mat), make_mesh(shards, device="cpu"),
                    dtype=np.float64, comm=comm)
    op = DistSpDMV(_csr(mat), _cards(shards), dtype=np.float64, comm=comm)
    assert op.comm == one.comm == comm and op.real == one.real
    assert op._graph is None and not op.capturable and one.capturable
    x = _x(mat.n, rhs)
    trace.collect()
    with trace.recording():
        y = op(x)
    rec = trace.collect()
    assert torch.equal(y, one(x))
    assert rec.counters["dist.copy_bytes"] == _schedule_bytes(op, rhs)
    assert "dist.graph_replays" not in rec.counters
    # a second apply reuses the buffers and returns a tensor of its own
    (bufs,) = op._bufs.values()
    y2 = op(x)
    assert op._bufs == {next(iter(op._bufs)): bufs}
    assert y2.data_ptr() != y.data_ptr() and torch.equal(y2, y)


@pytest.mark.parametrize("comm", ["halo", "gather", "ring"])
@pytest.mark.parametrize("rhs", [1, 8])
def test_a_general_matrix_across_cards(comm, rhs):
    mat = _mat("uneven")
    one = DistSpDMV(_csr(mat, False), make_mesh(4, device="cpu"),
                    dtype=np.float64, comm=comm)
    op = DistSpDMV(_csr(mat, False), _cards(4), dtype=np.float64, comm=comm)
    assert op.comm == comm and not op.symmetric
    x = _x(mat.n, rhs, seed=13)
    trace.collect()
    with trace.recording():
        y = op(x)
    assert torch.equal(y, one(x))
    assert trace.collect().counters["dist.copy_bytes"] == _schedule_bytes(
        op, rhs)


def test_a_halo_window_is_one_copy_of_x():
    """Each halo window is one copy of x's rows ``[d S - H, d S + S + H)``
    (clipped at the mesh's ends), whose rows outside x stay zero."""
    op = DistSpDMV(_csr(_mat("even")), _cards(4), dtype=np.float64,
                   comm="halo")
    S, H = op.shard_rows, op.halo_rows
    assert (S, H) == (1024, 256)
    assert [op._window(d) for d in range(4)] == [
        (H, 0, S + H), (0, S - H, 2 * S + H), (0, 2 * S - H, 3 * S + H),
        (0, 3 * S - H, 4 * S)]
    x = _x(op.nrows, 1)
    op(x)
    (bufs,) = op._bufs.values()
    assert [len(f) for f in bufs.fills] == [1] * 4
    assert torch.equal(bufs.xs[0][:H], torch.zeros(H, dtype=torch.float64))
    assert torch.equal(bufs.xs[3][H + S:], torch.zeros(H,
                                                       dtype=torch.float64))
    assert torch.equal(bufs.xs[2], x[2 * S - H:3 * S + H])


def test_the_multi_rhs_key_has_buffers_of_its_own():
    op = DistSpDMV(_csr(_mat("even")), _cards(4), dtype=np.float64,
                   comm="halo")
    op(_x(op.nrows, 1))
    op(_x(op.nrows, 3))
    assert sorted(op._bufs) == [((), torch.float64), ((3,), torch.float64)]
    assert op._bufs[((3,), torch.float64)].xs[1].shape == (
        op.shard_rows + 2 * op.halo_rows, 3)


@pytest.mark.parametrize("comm", ["halo", "gather", "ring"])
def test_a_one_device_mesh_reuses_its_buffers(comm):
    """Every shard's buffers on the one device, made at the first apply;
    a second apply fills the same ones and returns a tensor of its own,
    and no copy is counted between cards."""
    op = DistSpDMV(_csr(_mat("uneven")), make_mesh(4, device="cpu"),
                   dtype=np.float64, comm=comm)
    assert op.capturable and op._graph is None and not op._bufs
    x = _x(op.nrows, 1)
    trace.collect()
    with trace.recording():
        y = op(x)
    assert "dist.copy_bytes" not in trace.collect().counters
    (bufs,) = op._bufs.values()
    assert bufs.moved == 0 and all(b is not None for b in bufs.xs)
    y2 = op(x)
    assert list(op._bufs.values()) == [bufs]
    assert y2.data_ptr() != y.data_ptr() and torch.equal(y2, y)


@pytest.mark.parametrize("comm", ["halo", "gather", "ring"])
def test_a_process_group_mesh_holds_buffers_for_its_own_shard(comm):
    """Rank 1 of four uploads, fills and applies shard 1 alone, from the
    global x on its own device; its all-gather (here its own rows) is the
    one-device mesh's rows of that shard."""
    mat = _mat("even")
    op = DistSpDMV(_csr(mat), Mesh((torch.device("cpu"),) * 4,
                                   group=object(), rank=1),
                   dtype=np.float64, comm=comm)
    op._all_gather = lambda y: y
    x = _x(mat.n, 1)
    y = op(x)
    (bufs,) = op._bufs.values()
    assert [b is not None for b in bufs.xs] == [False, True, False, False]
    assert [b is not None for b in bufs.ys] == [False, True, False, False]
    assert [bool(f) for f in bufs.fills] == [False, True, False, False]
    assert bufs.moved == 0
    one = DistSpDMV(_csr(mat), make_mesh(4, device="cpu"), dtype=np.float64,
                    comm=comm)
    r0, nr = op.real[1]
    assert torch.equal(y[:nr], one(x)[r0:r0 + nr])


def test_on_one_device_the_exchanges_sit_under_the_scatter():
    op = DistSpDMV(_csr(_mat("even")), make_mesh(4, device="cpu"),
                   dtype=np.float64, comm="halo")
    trace.collect()
    with trace.recording():
        op(_x(op.nrows, 1))
    rec = trace.collect()
    (scatter,) = rec.named("cfs.dist.scatter")
    exchanges = rec.named("cfs.dist.exchange")
    assert len(exchanges) == 4
    assert all(s.parent == scatter.id for s in exchanges)
    assert rec.children(scatter) == exchanges


# --- on the card ----------------------------------------------------------
@pytest.fixture
def cards():
    """Two or more CUDA cards, else the test skips."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return torch.cuda.device_count()


def _on_cards(n_cards, grid=(32, 32, 64)):
    """HPCG at 32 x 32 x 64 (65,536 rows) in four halo shards over the
    cards (one a card on a node of four)."""
    nx, ny, nz = grid
    mat = matrices.make({"generator": "hpcg27", "nx": nx, "ny": ny,
                         "nz": nz})
    mesh = Mesh(tuple(torch.device("cuda", d % n_cards) for d in range(4)))
    trace.collect()
    with trace.recording():
        op = DistSpDMV(_csr(mat), mesh, dtype=np.float64, comm="halo")
    return mat, op, trace.collect()


def _eager(op, x):
    """The same apply without the graph: the schedule run eagerly."""
    graph, op._graph = op._graph, None
    try:
        return op(x)
    finally:
        op._graph = graph


@pytest.mark.card
def test_a_replay_is_the_eager_apply_bit_for_bit(cards):
    mat, op, built = _on_cards(cards)
    assert built.counters["dist.graph_captures"] == 1
    (build,) = built.named("cfs.dist.build")
    assert [s.name for s in built.children(build)] == [
        "cfs.dist.plan", "cfs.dist.upload", "cfs.dist.capture"]
    assert op._graph is not None and not op.capturable
    xs = [_x(mat.n, 1, seed=s).cuda() for s in range(3)]
    trace.collect()
    with trace.recording():
        ys = [op(x) for x in xs]
    rec = trace.collect()
    assert rec.counters["dist.graph_replays"] == 3
    assert len(rec.named("cfs.dist.replay")) == 3
    for (root, replay) in zip(rec.named("cfs.dist.apply"),
                              rec.named("cfs.dist.replay")):
        assert rec.children(root) == [replay]
    with trace.recording():
        eager = [_eager(op, x) for x in xs]
    rec_eager = trace.collect()
    assert "dist.graph_replays" not in rec_eager.counters
    assert rec.counters["dist.copy_bytes"] == rec_eager.counters[
        "dist.copy_bytes"] > 0
    for y, e in zip(ys, eager):
        assert torch.equal(y, e)
    assert len({y.data_ptr() for y in ys}) == 3
    ref = Reference(mat, op.device)
    err = (ys[0] - ref.matvec(xs[0])).abs().max() / ref.matvec(
        xs[0], absolute=True).max()
    assert err <= 1e-12


@pytest.mark.card
def test_cg_over_four_shards_replayed_matches_the_reference(cards):
    mat, op, _ = _on_cards(cards)
    ref = Reference(mat, op.device)
    b = ref.matvec(_x(mat.n, 1, seed=5).cuda())
    trace.collect()
    with trace.recording():
        x = solvers.cg(op, b, iters=50)[0]
    rec = trace.collect()
    # the first residual and 50 iterations, each one replay
    assert rec.counters["dist.graph_replays"] == 51
    assert rec.counters.get("solve.replays", 0) == 0
    x_ref = ref.cg(b, 50)
    err = torch.linalg.vector_norm(x - x_ref) / torch.linalg.vector_norm(
        x_ref)
    assert err <= 1e-10
