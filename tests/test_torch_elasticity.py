"""3-D linear elasticity (deal.II step-8, Q1, z-order DoFs) through the
port's float64 path, at CPU sizes: ne = 2, 4 and 8 cells a side, and 16
where the float64 peel has to take diagonals.

- The generator (``spmv_bench/generators/q1_elasticity.py``): its DoF
  numbering against labels written by hand at ne = 2; its matrix entry
  for entry against a plain numpy assembly element by element; the
  element and the unconstrained operator against the six rigid-body
  modes; symmetry and positive definiteness.
- The configuration's plain reference
  (``spmv_bench/references/q1_elasticity.py``): matrix-free, against the
  generator's CSR, and its CG.
- The port's float64 plan of it: the peel's diagonals and the stream's
  entries, the entry-list plan (``tune.build_fp64_plan(entries=True)``,
  which ``tune`` takes past ``FP64_ENTRIES_MIN_NNZ``, lowered here where a
  test wants it at a CPU size) against the grid plan, its key, its cache
  and its gate; ``SpDMV`` and ``cg`` against the reference; the float32
  control.
- The counters ``tune.fp64_nnz``, ``tune.fp64_stream_nnz`` and
  ``fp64.stream_*``, ``cfs.tune``'s ``fp64_stream`` attributes, the reader
  ``fp64_stream_share`` and ``far_ms_per_apply.apply`` on the double
  entries kernel; the cell ``elast128-spmv`` through ``spec`` and
  ``harness.run_cell`` on the CPU.
"""

import itertools
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.io import plancache
from cfs_spmv_tpu_torch.models import solvers
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.ops.fp64_entries import Fp64EntriesPlan
from cfs_spmv_tpu_torch.tuning import tune as tn
from cfs_spmv_tpu_torch.utils import trace
from spmv_bench import counts, harness, matrices, reference, spec
from spmv_bench import trace as tracing
from spmv_bench.generators import q1_elasticity as q1

torch.set_num_threads(1)

CELL = "elast128-spmv"
CONFIG = "dealii-elasticity-q1"


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


@pytest.fixture(scope="module")
def cfg(bench):
    return spec.config(bench, CONFIG)


@pytest.fixture(scope="module")
def Ref():
    return spec.reference("q1_elasticity")


def _at(cfg, refine, **kw):
    return {**cfg, "refine": refine, **kw}


def _csr(mat):
    return ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                  symmetric=True)


def _full(mat):
    """Both triangles of ``mat``, the stored zeros kept (scipy's sum of
    two matrices would drop them)."""
    row = np.repeat(np.arange(mat.n), np.diff(mat.indptr))
    col = mat.indices.astype(np.int64)
    off = row != col
    full = sp.coo_matrix(
        (np.concatenate([mat.data, mat.data[off]]),
         (np.concatenate([row, col[off]]), np.concatenate([col, row[off]]))),
        shape=(mat.n, mat.n)).tocsr()
    full.sort_indices()
    return full


# --- a plain numpy transcription, element by element ----------------------

def _np_numbering(ne):
    """Node of each vertex, by a loop over the cells in z-order."""
    m = ne + 1
    node = np.full(m**3, -1)
    nxt = 0
    for t in range(ne**3):
        c = [sum(((t >> (3 * b + i)) & 1) << b for b in range(ne.bit_length()))
             for i in range(3)]
        for dz, dy, dx in itertools.product((0, 1), repeat=3):
            v = (c[0] + dx) + m * ((c[1] + dy) + m * (c[2] + dz))
            if node[v] < 0:
                node[v], nxt = nxt, nxt + 1
    return node


def _np_assemble(ne, k, constrained=True):
    """The stiffness matrix by element triplets (scipy sums duplicates);
    constrained: rows and columns of boundary DoFs dropped but their own
    diagonal."""
    m = ne + 1
    node = _np_numbering(ne)
    rows, cols, vals = [], [], []
    for cz, cy, cx in itertools.product(range(ne), repeat=3):
        verts = [(cx + dx) + m * ((cy + dy) + m * (cz + dz))
                 for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        dofs = np.array([3 * node[v] + c for v in verts for c in range(3)])
        rows.append(np.repeat(dofs, 24))
        cols.append(np.tile(dofs, 24))
        vals.append(k.reshape(-1))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    if constrained:
        xyz = np.stack(np.unravel_index(np.argsort(node), (m, m, m))[::-1])
        fixed_node = ((xyz == 0) | (xyz == ne)).any(axis=0)
        fixed = np.repeat(fixed_node, 3)
        keep = (~fixed[r] & ~fixed[c]) | (r == c)
        r, c, v = r[keep], c[keep], v[keep]
    n = 3 * m**3
    a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a, node


def _rigid_modes(xyz):
    """The six rigid-body modes of points ``xyz`` (N, 3), DoF ``3 * point
    + component``: three shifts and three turns."""
    modes = []
    for c in range(3):
        u = np.zeros_like(xyz)
        u[:, c] = 1
        modes.append(u.reshape(-1))
    for i, j in ((0, 1), (1, 2), (2, 0)):
        u = np.zeros_like(xyz)
        u[:, i], u[:, j] = -xyz[:, j], xyz[:, i]
        modes.append(u.reshape(-1))
    return modes


def _node_xyz(ne, node, lo=-1.0, hi=1.0):
    """Each node's coordinates, in node order."""
    m = ne + 1
    v = np.argsort(node)
    return lo + (hi - lo) / ne * np.stack([v % m, (v // m) % m, v // (m * m)],
                                          axis=1)


#: deal.II's numbering of the 27 vertices of ne = 2 (vertex x + 3 y + 9 z),
#: worked out by hand: cell (0,0,0) numbers its 8 vertices 0-7, cell
#: (1,0,0) the 4 new ones 8-11, cell (0,1,0) 12-15, cell (1,1,0) 16-17,
#: cell (0,0,1) 18-21, cell (1,0,1) 22-23, cell (0,1,1) 24-25, and cell
#: (1,1,1) the last corner 26
HAND = [0, 1, 8, 2, 3, 9, 12, 13, 16, 4, 5, 10, 6, 7, 11, 14, 15, 17,
        18, 19, 22, 20, 21, 23, 24, 25, 26]


def test_the_numbering_at_ne_2_is_the_hand_written_one():
    for numbering in (q1.numbering(2, "cpu").numpy(), _np_numbering(2)):
        assert numbering.tolist() == HAND
    for ne in (4, 8):
        node = q1.numbering(ne, "cpu").numpy()
        assert np.array_equal(np.sort(node), np.arange((ne + 1) ** 3))
        assert np.array_equal(node, _np_numbering(ne))


def test_the_cells_are_visited_in_z_order():
    x, y, z = (a.numpy() for a in q1.z_order_cells(4, "cpu"))
    assert (x[:8].tolist(), y[:8].tolist(), z[:8].tolist()) == (
        [0, 1, 0, 1, 0, 1, 0, 1], [0, 0, 1, 1, 0, 0, 1, 1],
        [0, 0, 0, 0, 1, 1, 1, 1])
    assert (x[8], y[8], z[8]) == (2, 0, 0)  # the next octant in x
    assert len(set(zip(x, y, z))) == 64


@pytest.mark.parametrize("ne", [2, 4, 8])
def test_the_generator_is_the_element_by_element_assembly(cfg, ne):
    mat = matrices.make(_at(cfg, ne.bit_length() - 1))
    k = q1.element_matrix(2 / ne, 1.0, 1.0)
    want, _ = _np_assemble(ne, k)
    low = sp.tril(want).tocsr()
    low.sort_indices()
    assert mat.n == 3 * (ne + 1) ** 3
    assert mat.indptr.dtype == np.int64 and mat.indices.dtype == np.int32
    assert mat.data.dtype == np.float64
    assert np.array_equal(mat.indptr, low.indptr)
    assert np.array_equal(mat.indices, low.indices)
    np.testing.assert_allclose(mat.data, low.data, rtol=0,
                               atol=1e-14 * np.abs(low.data).max())
    # an interior row holds 81 entries in both triangles (at ne = 2 the one
    # free node has only constrained neighbours); a free node has 3 ne - 5
    # free neighbours summed along an axis, a constrained DoF its diagonal
    assert mat.logical_nnz == 9 * (3 * ne - 5) ** 3 + 3 * (
        (ne + 1) ** 3 - (ne - 1) ** 3)
    assert np.diff(_full(mat).indptr).max() == (81 if ne >= 4 else 3)


def test_the_matrix_is_a_function_of_the_configuration(cfg):
    a = matrices.make(_at(cfg, 3))
    b = matrices.make(_at(cfg, 3))
    assert all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("indptr", "indices", "data"))
    c = matrices.make(_at(cfg, 3, mu=2.0))
    assert np.array_equal(a.indices, c.indices)
    assert not np.array_equal(a.data, c.data)


def test_the_element_and_operator_annihilate_the_rigid_modes():
    ne = 4
    k = q1.element_matrix(2 / ne, 1.0, 1.0)
    # a cell's 8 corners, lexicographic, x fastest
    corners = 0.3 + (2 / ne) * np.array(
        [[a & 1, (a >> 1) & 1, a >> 2] for a in range(8)], float)
    for mode in _rigid_modes(corners):
        assert np.abs(k @ mode).max() < 1e-12
    full, node = _np_assemble(ne, k, constrained=False)
    xyz = _node_xyz(ne, node)
    for mode in _rigid_modes(xyz):
        assert np.abs(full @ mode).max() < 1e-12
    # a stretch is no rigid motion: it is not annihilated
    stretch = np.zeros_like(xyz)
    stretch[:, 0] = xyz[:, 0]
    assert np.abs(full @ stretch.reshape(-1)).max() > 1e-3


def test_the_reference_element_is_the_generators(Ref):
    from spmv_bench.references import q1_elasticity as refmod

    for h, lam, mu in ((0.5, 1.0, 1.0), (2 / 128, 1.0, 1.0), (0.1, 2.0, 0.5)):
        a = q1.element_matrix(h, lam, mu)
        b = refmod.stiffness(h, lam, mu).numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14 * np.abs(a).max())
        assert np.abs(a - a.T).max() < 1e-15 * np.abs(a).max()


def test_the_matrix_is_symmetric_positive_definite(cfg):
    mat = matrices.make(_at(cfg, 2))
    a = _full(mat).toarray()
    assert np.array_equal(a, a.T)
    np.linalg.cholesky(a)  # raises unless positive definite
    w = np.linalg.eigvalsh(a)
    assert w.min() > 0.1 * (2 / 4) and w.max() / w.min() < 100


@pytest.mark.parametrize("refine", [1, 2, 3])
@pytest.mark.parametrize("rhs", [1, 3])
def test_the_reference_is_matrix_free_and_agrees(cfg, Ref, refine, rhs):
    mat = matrices.make(_at(cfg, refine))
    ref = Ref(mat, "cpu")
    g = torch.Generator().manual_seed(refine)
    shape = (mat.n,) if rhs == 1 else (mat.n, rhs)
    x = torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1
    a = _full(mat)
    want = a @ x.numpy()
    assert np.abs(ref.matvec(x).numpy() - want).max() < 1e-14 * np.abs(
        want).max()
    assert np.array_equal(ref.matvec(x, absolute=True).numpy(),
                          abs(a) @ np.abs(x.numpy()))


def test_the_reference_takes_nothing_of_the_program(Ref):
    from spmv_bench import guard

    path = os.path.join(spec.HERE, "references", "q1_elasticity.py")
    names = guard.imported(path)
    assert not names & (guard.FORBIDDEN | {guard.PORT})
    assert "spmv_bench" not in names  # nor the generator
    assert torch.backends.cuda.matmul.allow_tf32 is False


# --- the port's float64 plan ----------------------------------------------

def _op(mat, *, dtype=np.float64, cache_dir="", **kw):
    return ct.SpDMV(ct.SparseMatrix.create(_csr(mat), ct.Format.SSS),
                    ct.Tuning.AGGRESSIVE, dtype=dtype, device="cpu",
                    cache_dir=cache_dir, **kw)


#: the smallest mesh the float64 peel takes (16^3 cells, 14,739 rows): at
#: ne = 8 the dense diagonals hold under the planner's 25% of the entries
PEELED = 4


def _form(monkeypatch, stream: str) -> None:
    """The float64 plan form ``tune`` takes at these sizes: ``"entries"``
    lowers ``FP64_ENTRIES_MIN_NNZ`` under every matrix, as the cell's size
    passes it; ``"auto"`` keeps it (the grid plan)."""
    if stream == "entries":
        monkeypatch.setattr(tn, "FP64_ENTRIES_MIN_NNZ", 0)


@pytest.mark.parametrize("stream", ["entries", "auto"])
def test_the_plan_peels_diagonals_and_streams_the_rest(cfg, stream,
                                                       monkeypatch):
    mat = matrices.make(_at(cfg, PEELED))
    _form(monkeypatch, stream)
    with trace.recording():
        op = _op(mat)
        op(torch.ones(mat.n, dtype=torch.float64))
        op(torch.ones((mat.n, 3), dtype=torch.float64))
    rec = trace.collect()
    tuned = op.A.tuned
    plan, dev = tuned.plan, tuned.operands
    assert isinstance(plan, Fp64EntriesPlan) is (stream == "entries")
    assert plan.dia is not None and len(plan.dia.offsets) >= 20
    assert 0 in plan.dia.offsets and 1 in plan.dia.offsets
    (ts,) = rec.named("cfs.tune")
    assert ts.attrs["fp64_plan"] == "sdia"
    assert ts.attrs["sdia_diagonals"] == len(plan.dia.offsets)
    assert rec.counters["tune.fp64_nnz"] == tuned.nnz_full == mat.logical_nnz
    # what the peel leaves, both triangles: either plan holds every stored
    # entry of it, and the counter counts them; the entry list reaches the
    # card as the live ones, the grid (grouped at this size) whole
    low = sp.tril(_full(mat)).tocoo()
    rest = ~np.isin(low.row - low.col, plan.dia.offsets)
    live = rest & (low.data != 0)
    assert rec.counters["tune.fp64_stream_nnz"] == plan.nnz == 2 * rest.sum()
    if stream == "entries":
        assert ts.attrs["fp64_stream"] == "entries"
        assert ts.attrs["fp64_stream_slots"] == 0
        assert dev.entries.count == 2 * live.sum() > 0
    else:
        assert ts.attrs["fp64_stream"] == "grouped" and dev.grouped
        assert ts.attrs["fp64_stream_slots"] == plan.num_chunks * 1024
    # one count of the stream's form an apply, SpMV and SpMM
    assert rec.counters[f"fp64.stream_{ts.attrs['fp64_stream']}"] == 2


def test_the_entry_list_is_what_the_peel_leaves(cfg):
    """The entry-list plan peels as the grid plan does, and reaches the
    card as the live entries off the peeled diagonals, both triangles,
    each row's columns ascending; the two plans give one product."""
    mat = matrices.make(_at(cfg, PEELED))
    csr = _csr(mat)
    grid = tn.build_fp64_plan(csr)
    lst = tn.build_fp64_plan(csr, entries=True)
    assert grid.dia.offsets == lst.dia.offsets
    assert np.array_equal(grid.dia.vals, lst.dia.vals)
    e = ops.fp64_to_device(lst, "cpu").entries
    full = _full(mat).tocoo()
    off = ~np.isin(np.abs(full.row - full.col), lst.dia.offsets)
    off &= full.data != 0
    want = np.lexsort((full.col[off], full.row[off]))
    assert e.count == off.sum() and lst.nnz == grid.nnz
    assert np.array_equal(e.rows.numpy(), full.row[off][want])
    assert np.array_equal(e.cols.numpy(), full.col[off][want])
    assert np.array_equal(e.vals.numpy(), full.data[off][want])
    assert e.rows.dtype == e.cols.dtype == torch.int32
    assert e.min_tiles == -(-(full.row[off].max() + 1) // 128)
    x = torch.rand(mat.n, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    ys = [ops.fp64_apply(ops.fp64_to_device(p, "cpu"), x)
          for p in (grid, lst)]
    assert torch.allclose(ys[0], ys[1], rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("rhs", [1, 3])
def test_a_diagonal_only_plan_is_the_same_in_both_forms(rhs, monkeypatch):
    """A plan the peel takes whole (HPCG's stencil) uploads no entries in
    either form and gives the same bits."""
    mat = matrices.make({"generator": "hpcg27", "nx": 12, "ny": 11, "nz": 10})
    x = torch.rand((mat.n,) if rhs == 1 else (mat.n, rhs),
                   generator=torch.Generator().manual_seed(rhs),
                   dtype=torch.float64)
    ys = []
    for stream in ("auto", "entries"):
        _form(monkeypatch, stream)
        op = _op(mat)
        dev = op.A.tuned.operands
        assert dev.entries is None and not dev.has_work
        assert dev.x_rows == dev.num_row_tiles == -(-mat.n // 128)
        ys.append(op(x))
    assert torch.equal(ys[0], ys[1])


def test_past_the_gate_the_plan_is_an_entry_list_under_its_own_key(
        cfg, tmp_path, monkeypatch):
    mat = matrices.make(_at(cfg, PEELED))
    csr = _csr(mat)
    assert mat.stored_nnz <= tn.FP64_ENTRIES_MIN_NNZ
    kinds = {}
    for gate in (mat.stored_nnz, mat.stored_nnz - 1):
        monkeypatch.setattr(tn, "FP64_ENTRIES_MIN_NNZ", gate)
        kinds[gate] = type(tn.tune(csr, dtype=np.float64, device="cpu",
                                   cache_dir=str(tmp_path)).plan)
    assert kinds[mat.stored_nnz].__name__ == "Bell2Plan"
    assert kinds[mat.stored_nnz - 1] is Fp64EntriesPlan
    grid_key = plancache.cache_key(csr, np.float64, fmt="bell2_f64",
                                   sdia_rows="any")
    entries_key = plancache.cache_key(csr, np.float64, fmt="bell2_f64",
                                      sdia_rows="any", fp64_stream="entries")
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"plan-{k}.npz" for k in (grid_key, entries_key))


def test_the_entry_list_plan_round_trips_through_the_cache(cfg, tmp_path,
                                                          monkeypatch):
    mat = matrices.make(_at(cfg, PEELED))
    _form(monkeypatch, "entries")
    runs = []
    for _ in range(2):
        with trace.recording():
            op = _op(mat, cache_dir=str(tmp_path))
            y = op(torch.ones(mat.n, dtype=torch.float64))
        runs.append((op.A.tuned.plan, trace.collect(), y))
    (built, rb, yb), (loaded, rl, yl) = runs
    assert rb.counters["plancache.misses"] == 1
    assert rl.counters["plancache.hits"] == 1
    assert isinstance(loaded, Fp64EntriesPlan) and loaded.nnz == built.nnz
    for f in ("row", "col", "val"):
        got = getattr(loaded, f)
        assert got.dtype == getattr(built, f).dtype
        assert np.array_equal(got, getattr(built, f))
    assert loaded.dia.offsets == built.dia.offsets
    for name in ("tune.fp64_nnz", "tune.fp64_stream_nnz"):
        assert rl.counters[name] == rb.counters[name] > 0
    assert torch.equal(yb, yl)


def test_float32_ignores_the_float64_gate(cfg, monkeypatch):
    mat = matrices.make(_at(cfg, 1))
    b = _op(mat, dtype=np.float32).A.tuned
    _form(monkeypatch, "entries")
    a = _op(mat, dtype=np.float32).A.tuned
    assert a.dtype == b.dtype == torch.float32
    assert type(a.plan) is type(b.plan)
    x = torch.rand(mat.n, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.matvec(x), b.matvec(x))


def test_an_unpeeled_matrix_keeps_the_grid_past_the_gate(cfg, monkeypatch):
    """Where the peel takes nothing (ne = 8) the plan past the gate is
    the grid, whose degree-grouped stream writes each row once."""
    mat = matrices.make(_at(cfg, 3))
    grid = tn.build_fp64_plan(_csr(mat))
    _form(monkeypatch, "entries")
    with trace.recording():
        op = _op(mat)
    rec = trace.collect()
    plan = op.A.tuned.plan
    assert grid.dia is None and plan.dia is None
    assert type(plan) is type(grid) and plan.nnz == grid.nnz
    assert np.array_equal(plan.vals, grid.vals)
    (ts,) = rec.named("cfs.tune")
    assert ts.attrs["fp64_stream"] in ("grid", "grouped")
    assert rec.counters["tune.fp64_stream_nnz"] == plan.nnz


@pytest.mark.parametrize("refine", [PEELED, PEELED + 1])
def test_both_forms_upload_the_same_live_entries(cfg, refine, monkeypatch):
    """A stored zero (the cancelled couplings deal.II's pattern keeps)
    stays in either host plan and drops out at upload in either form: the
    grid's compaction (``compact_stream``) and the entry list's expansion
    (``lower_entries``) give the card the same entries, and the counters
    the same stored count."""
    mat = matrices.make(_at(cfg, refine))
    csr = _csr(mat)
    grid = tn.build_fp64_plan(csr)
    lst = tn.build_fp64_plan(csr, entries=True)
    assert grid.nnz == lst.nnz > 0
    assert np.count_nonzero(lst.val == 0) > 0
    e = ops.fp64_to_device(lst, "cpu").entries
    g = bk.compact_stream(
        grid.vals, grid.packed, grid.meta, grid.step_block,
        chunks_per_step=grid.chunks_per_step,
        tiles_per_block=grid.tiles_per_block,
        contig=grid.windows_contig or grid.window_depth > 8,
        num_row_tiles=grid.num_row_tiles, x_rows=grid.x_rows)
    live = lst.val != 0
    assert e.count == g.count == (2 * np.count_nonzero(live) - np.count_nonzero(
        live & (lst.row == lst.col)))
    if grid.row_perm is None:  # the grid's rows as they are: one entry set
        key = [torch.sort(s.rows.long() * mat.n + s.cols.long())
               for s in (e, g)]
        assert torch.equal(key[0].values, key[1].values)
        assert torch.equal(e.vals[key[0].indices], g.vals[key[1].indices])
    counted = []
    for stream in ("auto", "entries"):
        _form(monkeypatch, stream)
        with trace.recording():
            _op(mat)
        counted.append(trace.collect().counters["tune.fp64_stream_nnz"])
    assert counted == [grid.nnz, grid.nnz]


@pytest.mark.parametrize("refine", [2, PEELED])
@pytest.mark.parametrize("stream", ["entries", "auto"])
@pytest.mark.parametrize("rhs", [1, 8])
def test_the_float64_path_holds_to_the_reference(cfg, Ref, refine, stream,
                                                  rhs, monkeypatch):
    mat = matrices.make(_at(cfg, refine))
    _form(monkeypatch, stream)
    op = _op(mat)
    ref = Ref(mat, "cpu")
    g = torch.Generator().manual_seed(refine + rhs)
    x = torch.rand((mat.n,) if rhs == 1 else (mat.n, rhs), generator=g,
                   dtype=torch.float64) * 2 - 1
    y = op(x)
    assert y.dtype == torch.float64 and y.shape == x.shape
    err = reference.apply_error(y, ref.matvec(x),
                                ref.matvec(x, absolute=True))
    assert err < 1e-14 <= cfg["limits"]["apply_err"]


def test_the_float32_control_fails_the_limit_at_its_own_rounding(cfg, Ref):
    assert cfg["control"] == {"dtype": "float32"}
    mat = matrices.make(_at(cfg, 3))
    op = _op(mat, dtype=np.float32)
    ref = Ref(mat, "cpu")
    x = torch.rand(mat.n, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64) * 2 - 1
    err = reference.apply_error(op(x.float()), ref.matvec(x),
                                ref.matvec(x, absolute=True))
    assert 1e3 * cfg["limits"]["apply_err"] < err < 1e-5


def test_cg_agrees_with_the_references(cfg, Ref, monkeypatch):
    mat = matrices.make(_at(cfg, 3))
    _form(monkeypatch, "entries")
    op = _op(mat)
    ref = Ref(mat, "cpu")
    b = ref.matvec(torch.rand(mat.n, generator=torch.Generator()
                              .manual_seed(9), dtype=torch.float64))
    x = solvers.cg(op, b, iters=30)[0]
    x_ref = ref.cg(b, 30)
    assert reference.solve_error(x, x_ref) < 1e-10
    # thirty iterations reduce the residual of this well-conditioned SPD
    # system by orders of magnitude
    r = b - ref.matvec(x_ref)
    assert torch.linalg.vector_norm(r) < 1e-3 * torch.linalg.vector_norm(b)


# --- the benchmark's pieces ------------------------------------------------

def test_the_cell_and_configuration_load_through_spec(bench, cfg):
    cell = spec.cell(bench, CELL)
    assert cell["config"] == CONFIG and cell["traffic"] == "spmv"
    assert cell["chips"] == 1
    assert spec.operator(cfg, 1) == "SpDMV"
    assert cfg["precision"] == "float64" and cfg["refine"] == 7
    assert cfg["tune"] == {"format": "SSS", "tuning": "AGGRESSIVE"}
    assert harness.reference_for(cfg).__module__ == \
        "spmv_bench.references.q1_elasticity"
    assert spec.generator(cfg["generator"]).make is not None
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == cfg["reduced"] == []
    e2e = {m["name"] for m in spec.metrics_for(bench, CELL, False)}
    assert e2e == {"setup_s", "apply_gflop_s"}
    per_layer = {m["name"] for m in spec.metrics_for(bench, CELL, True)}
    assert {"fp64_stream_share", "far_ms_per_apply.apply", "spmv_roofline",
            "plan_load_s", "upload_s"} <= per_layer
    for name in per_layer:
        assert spec.reader(name) is not None


@pytest.mark.parametrize("seed", [2**31 + 11, 7])
def test_the_cell_runs_correct_on_the_cpu(bench, cfg, tmp_path, seed):
    out = harness.run_cell(bench, CELL, seed, 0.2, False, device="cpu",
                           cache=str(tmp_path), cfg=_at(cfg, 3))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "apply_gflop_s"}
    assert out["checks"]["apply_err"]["value"] < 1e-14


def test_a_traced_cell_reads_the_new_metric(bench, cfg, monkeypatch,
                                            tmp_path):
    """A ``--trace 1`` run at a CPU size, in the cell's plan form (the
    gate lowered), the profiler's window stood in for by synthetic events
    of the apply's kernels (the CPU has no device events)."""
    def record(work, tries=3, cards=1):
        work()
        return tracing.Trace(_events([
            ("bell2_entries_kernel<1, double, double>", 0, 60),
            ("sdia_sym_kernel<double, 1, double>", 60, 25),
            ("Memcpy DtoD (Device -> Device)", 85, 5)]), cards=cards)

    monkeypatch.setattr(tracing, "record", record)
    _form(monkeypatch, "entries")
    out = harness.run_cell(bench, CELL, 12, 0.2, True, device="cpu",
                           cache=str(tmp_path), cfg=_at(cfg, PEELED))
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    mat = matrices.make(_at(cfg, PEELED))
    op = _op(mat)
    assert isinstance(op.A.tuned.plan, Fp64EntriesPlan)
    assert m["fp64_stream_share"] == pytest.approx(
        100 * op.A.tuned.plan.nnz / mat.logical_nnz)
    # the peel takes the dense diagonals, the stream the rest
    assert 20 < m["fp64_stream_share"] < 90
    traced = 3 / m["launches_per_apply.apply"]
    assert m["far_ms_per_apply.apply"] == pytest.approx(0.060 / traced)


def _events(kernels):
    """A 100-us window holding ``kernels`` (name, ts, dur) on one card."""
    ev = [{"name": tracing.WINDOW, "cat": "user_annotation", "ph": "X",
           "ts": 0, "dur": 100}]
    return ev + [{"name": f"void {name}(double const*)", "cat": "kernel",
                  "ph": "X", "ts": ts, "dur": dur, "args": {"device": 0}}
                 for name, ts, dur in kernels]


def _run(record):
    return harness.Run(
        kind="apply", rhs=1, iters=0, setup_s=1.0, tune_upload_s=1.0,
        window_s=1.0, done=10, host_call_s=0.0, solve_walls_s=[], loop_s=[],
        logical_nnz=100, precision="float64", apply_bytes=800,
        value_bytes=400, plan_bytes=4000,
        peak=counts.peak_for("NVIDIA H100 80GB HBM3"), traced=4,
        setup_record=record)


def test_the_share_reader_on_synthetic_records():
    from cfs_spmv_tpu_torch.utils.trace import Record

    read = spec.reader("fp64_stream_share")
    assert read(_run(None)) is None
    assert read(_run(Record([], {}))) is None  # a program without them
    assert read(_run(Record([], {"tune.fp32_nnz": 10}))) is None
    assert read(_run(Record([], {"tune.fp64_nnz": 200,
                                 "tune.fp64_stream_nnz": 0}))) == 0.0
    assert read(_run(Record([], {"tune.fp64_nnz": 200,
                                 "tune.fp64_stream_nnz": 127}))) == 63.5
