"""The Graph500 Kronecker graph's normalized adjacency through the port's
float32 symmetric path, at CPU sizes.

- The generator (``spmv_bench/generators/graph500_kron.py``): its draws
  against a numpy transcription of splitmix64, its edges against a direct
  numpy transcription of ``kronecker_generator.m`` on the same draws, and
  the merged matrix (a symmetric lower triangle with its unit diagonal, no
  self loop, no duplicate, values -alpha / sqrt(d_i d_j)) against one
  built entry by entry from those edges.
- ``SpDMV`` in float32 on those graphs against the benchmark's plain
  reference (``spmv_bench/reference.py``) at B = 1 and 8, with RCM left to
  ``"auto"``, forced and off, within the configuration's ``apply_err``
  limit; the same path with bfloat16 values over it.
- The port's counters and spans of the plan: ``tune.fp32_nnz``,
  ``tune.fp32_far_nnz`` (built or loaded), ``cfs.tune``'s ``fp32_plan``,
  ``cfs.plan.reorder``'s attributes, and ``sbell.far_grouped`` /
  ``sbell.far_entries`` an apply.
- The cell ``kron-spmv`` through ``harness.run_cell`` on the CPU at a
  small SCALE, and the three readers it adds, on synthetic records.

The card's half (the same bits from the card's draws, the cell's path at
SCALE 18) is ``tests/test_torch_kron_card.py``.
"""

import os

import numpy as np
import pytest
import torch

import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu_torch.utils import trace
from cfs_spmv_tpu_torch.utils.trace import Record, Span
from spmv_bench import counts, harness, matrices, reference, spec
from spmv_bench import trace as tracing
from spmv_bench.generators import graph500_kron as kron

torch.set_num_threads(1)

CELL = "kron-spmv"


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


@pytest.fixture(scope="module")
def cfg(bench):
    return spec.config(bench, spec.cell(bench, CELL)["config"])


def _at(cfg, scale, **kw):
    return {**cfg, "scale": scale, **kw}


def _np_draws(key, start, count):
    """splitmix64 in numpy's uint64, the transcription the torch draws are
    held to."""
    with np.errstate(over="ignore"):
        z = (np.arange(start, start + count, dtype=np.uint64)
             * np.uint64(kron.GOLDEN % 2**64) + np.uint64(key % 2**64))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(kron.MIX1 % 2**64)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(kron.MIX2 % 2**64)
        z ^= z >> np.uint64(31)
    return (z >> np.uint64(11)).astype(np.int64)


def _kronecker_generator_m(scale, edgefactor, initiator, key):
    """``kronecker_generator.m`` line by line in numpy (1-based labels,
    ``rand`` and ``randperm`` replaced by the same draws as the port's
    stream, compared as floats), without the final edge shuffle: the
    0-based (i, j)."""
    A, B, C, _ = initiator
    N, M = 2**scale, edgefactor * 2**scale
    ij = np.ones((2, M), np.int64)
    ab = A + B
    c_norm = C / (1 - (A + B))
    a_norm = A / (A + B)
    for ib in range(1, scale + 1):
        u1 = _np_draws(key, 2 * (ib - 1) * M, M) / 2.0**53
        u2 = _np_draws(key, (2 * (ib - 1) + 1) * M, M) / 2.0**53
        ii_bit = u1 > ab
        jj_bit = u2 > (c_norm * ii_bit + a_norm * np.logical_not(ii_bit))
        ij = ij + 2 ** (ib - 1) * np.stack([ii_bit, jj_bit])
    p = np.argsort(_np_draws(key, 2 * scale * M, N), kind="stable") + 1
    ij = p[ij - 1]  # p(ij), 1-based
    return ij - 1


def _matrix_by_entries(i, j, n, alpha):
    """The lower triangle with its unit diagonal, built one edge at a
    time: {(row, col): value}."""
    nbrs = [set() for _ in range(n)]
    for a, b in zip(i.tolist(), j.tolist()):
        if a != b:
            nbrs[a].add(b)
            nbrs[b].add(a)
    out = {(r, r): np.float32(1.0) for r in range(n)}
    for r in range(n):
        for c in nbrs[r]:
            if c < r:
                out[(r, c)] = np.float32(
                    -alpha / np.sqrt(float(len(nbrs[r]) * len(nbrs[c]))))
    return out


def test_the_draws_are_splitmix64():
    key = kron.seed_key(500)
    # splitmix64 of a seed, done by hand on Python's integers
    z = (500 + 0x9E3779B97F4A7C15) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    assert key % 2**64 == z ^ (z >> 31)
    for start in (0, 2**40 + 3):
        got = kron.draws(key, start, 4096, "cpu").numpy()
        assert np.array_equal(got, _np_draws(key, start, 4096))
    u = kron.draws(key, 0, 1 << 16, "cpu").double() / 2**53
    assert 0 <= u.min() and u.max() < 1
    assert abs(u.mean().item() - 0.5) < 0.01


@pytest.mark.parametrize("scale", [6, 9, 12])
def test_the_edges_are_kronecker_generator_m_on_the_same_draws(cfg, scale):
    i, j = kron.edges(scale, 16, cfg["initiator"], cfg["graph_seed"], "cpu")
    want = _kronecker_generator_m(scale, 16, cfg["initiator"],
                                  kron.seed_key(cfg["graph_seed"]))
    assert np.array_equal(i.numpy(), want[0])
    assert np.array_equal(j.numpy(), want[1])
    assert len(i) == 16 * 2**scale
    assert int(i.max()) < 2**scale and int(i.min()) >= 0


@pytest.mark.parametrize("scale", [6, 8])
def test_the_matrix_is_the_merged_graphs_normalized_adjacency(cfg, scale):
    i, j = kron.edges(scale, 16, cfg["initiator"], cfg["graph_seed"], "cpu")
    want = _matrix_by_entries(i.numpy(), j.numpy(), 2**scale, cfg["alpha"])
    n, indptr, indices, data = kron.make(_at(cfg, scale), device="cpu")
    rows = np.repeat(np.arange(n), np.diff(indptr))
    got = dict(zip(zip(rows.tolist(), indices.tolist()), data.tolist()))
    assert len(got) == len(indices)  # no duplicate
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)  # the same float32 bits


@pytest.mark.parametrize("scale", [6, 10, 12])
def test_the_matrix_is_a_lower_triangle_with_its_unit_diagonal(cfg, scale):
    n, indptr, indices, data = kron.make(_at(cfg, scale), device="cpu")
    again = kron.make(_at(cfg, scale), device="cpu")
    assert all(np.array_equal(a, b) for a, b in
               zip((indptr, indices, data), again[1:]))
    assert n == 2**scale and indptr[0] == 0 and indptr[-1] == len(indices)
    assert indptr.dtype == np.int64 and indices.dtype == np.int32
    assert data.dtype == np.float32
    rows = np.repeat(np.arange(n), np.diff(indptr))
    last = indptr[1:] - 1
    # every row ends in its diagonal, 1, and holds nothing else on it
    assert np.array_equal(indices[last], np.arange(n))
    assert np.all(data[last] == 1.0)
    off = np.ones(len(indices), bool)
    off[last] = False
    assert np.all(indices[off] < rows[off])
    # columns strictly ascending in a row: no duplicate
    same_row = rows[1:] == rows[:-1]
    assert np.all(np.diff(indices.astype(np.int64))[same_row] > 0)
    # the values: -alpha / sqrt(d_i d_j), d the merged degrees
    deg = np.bincount(rows[off], minlength=n) + np.bincount(indices[off],
                                                            minlength=n)
    want = (-cfg["alpha"] / np.sqrt(deg[rows[off]].astype(np.float64)
                                    * deg[indices[off]])).astype(np.float32)
    assert np.array_equal(data[off], want)
    # the skew, growing with the scale: isolated vertices, and hubs far
    # above the mean degree
    assert np.mean(deg == 0) > 0.05
    assert deg.max() > 2 ** (scale / 2 - 1.5) * deg.mean()


def test_another_graph_seed_is_another_graph(cfg):
    a = kron.make(_at(cfg, 8), device="cpu")
    b = kron.make(_at(cfg, 8, graph_seed=cfg["graph_seed"] + 1),
                  device="cpu")
    assert not (np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))


def _op(mat, *, values="same", reorder="auto", cache_dir=""):
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    a = ct.SparseMatrix.create(csr, ct.Format.SSS)
    return ct.SpDMV(a, ct.Tuning.AGGRESSIVE, dtype=np.float32, device="cpu",
                    cache_dir=cache_dir, reorder=reorder, values=values)


def _apply_err(op, mat, rhs, seed):
    ref = reference.Reference(mat, "cpu")
    g = torch.Generator().manual_seed(seed)
    shape = (mat.n,) if rhs == 1 else (mat.n, rhs)
    x = torch.rand(shape, generator=g, dtype=torch.float32) * 2 - 1
    y = op(x)
    assert y.shape == shape and y.dtype == torch.float32
    return reference.apply_error(y, ref.matvec(x),
                                 ref.matvec(x, absolute=True))


@pytest.mark.parametrize("reorder", ["auto", True, False])
@pytest.mark.parametrize("scale", [10, 12])
@pytest.mark.parametrize("rhs", [1, 8])
def test_the_float32_path_holds_to_the_reference(cfg, scale, reorder, rhs):
    mat = matrices.make(_at(cfg, scale))
    err = _apply_err(_op(mat, reorder=reorder), mat, rhs, seed=scale + rhs)
    assert err <= cfg["limits"]["apply_err"]
    assert err < 1e-6  # float32's rounding, far under the limit


@pytest.mark.parametrize("scale", [10, 12])
@pytest.mark.parametrize("rhs", [1, 8])
def test_bfloat16_values_fail_the_configurations_limit(cfg, scale, rhs):
    assert cfg["control"] == {"values": "bfloat16"}
    mat = matrices.make(_at(cfg, scale))
    err = _apply_err(_op(mat, values="bfloat16"), mat, rhs, seed=scale)
    assert err > 10 * cfg["limits"]["apply_err"]


def _tuned_record(mat, **kw):
    with trace.recording():
        op = _op(mat, **kw)
        op(torch.ones(mat.n))
        op(torch.ones((mat.n, 3)))
    return op, trace.collect()


@pytest.mark.parametrize("reorder", ["auto", True, False])
def test_the_plan_is_traced(cfg, reorder):
    mat = matrices.make(_at(cfg, 12))
    op, rec = _tuned_record(mat, reorder=reorder)
    tuned = op.A.tuned
    plan = tuned.plan
    assert rec.counters["tune.fp32_nnz"] == plan.nnz_full == mat.logical_nnz
    assert rec.counters["tune.fp32_far_nnz"] == plan.far.nnz
    # nearly every entry of a scattered power-law graph goes far
    assert rec.counters["tune.fp32_far_nnz"] > 0.9 * plan.nnz_full
    (tune_span,) = rec.named("cfs.tune")
    streams = tune_span.attrs["fp32_plan"]
    assert streams["padding_ratio"] == plan.padding_ratio
    form = "far_grouped" if plan.far.row_perm is not None else "far_entries"
    assert streams[form] == plan.far.nnz
    assert set(streams) <= {"sdia", "paired", "far_grouped", "far_entries",
                            "padding_ratio"}
    # one count of the far stream's form an apply, SpMV and SpMM
    assert rec.counters[f"sbell.{form}"] == 2
    reorders = rec.named("cfs.plan.reorder")
    if reorder is False:
        assert not reorders and tuned.perm is None
        return
    (rs,) = reorders
    rcm = rs.attrs["rcm"]
    assert rcm is (tuned.perm is not None)
    assert rcm or reorder == "auto"
    assert rs.attrs["bw_gain"] == pytest.approx(
        rs.attrs["bw_before"] / rs.attrs["bw_after"])
    # a rejected permutation leaves the bandwidth as it was
    assert (rs.attrs["bw_gain"] > 1) is rcm


def test_the_counters_come_from_a_loaded_plan_too(cfg, tmp_path):
    mat = matrices.make(_at(cfg, 10))
    _, built = _tuned_record(mat, cache_dir=str(tmp_path))
    _, loaded = _tuned_record(mat, cache_dir=str(tmp_path))
    assert built.counters["plancache.misses"] == 1
    assert loaded.counters["plancache.hits"] == 1
    for name in ("tune.fp32_nnz", "tune.fp32_far_nnz"):
        assert loaded.counters[name] == built.counters[name] > 0
    assert (loaded.named("cfs.tune")[0].attrs["fp32_plan"]
            == built.named("cfs.tune")[0].attrs["fp32_plan"])


def test_past_the_relax_ceiling_the_plan_skips_the_relaxed_search(
        cfg, tmp_path, monkeypatch):
    """A matrix past ``tune.RELAX_MAX_NNZ`` stored entries is planned with
    ``allow_relax=False`` under a key of its own (the default key stays
    the reference's), and its far stream reaches the card ungrouped, as
    its entries: the same product within float32's rounding."""
    from cfs_spmv_tpu_torch.io.plancache import cache_key
    from cfs_spmv_tpu_torch.tuning import tune as tn

    mat = matrices.make(_at(cfg, 11))
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    assert mat.stored_nnz <= tn.RELAX_MAX_NNZ
    ops, keys = {}, {}
    for ceiling in (tn.RELAX_MAX_NNZ, mat.stored_nnz - 1):
        monkeypatch.setattr(tn, "RELAX_MAX_NNZ", ceiling)
        with trace.recording():
            t = tn.tune(csr, dtype=np.float32, device="cpu", reorder=False,
                        cache_dir=str(tmp_path))
        relaxed = trace.collect().named("cfs.tune")[0].attrs["allow_relax"]
        assert relaxed is (ceiling >= mat.stored_nnz)
        ops[relaxed] = t
        keys[relaxed] = cache_key(csr, np.float32, fmt="sbell",
                                  values="same",
                                  **({} if relaxed else
                                     {"allow_relax": False}))
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"plan-{k}.npz" for k in keys.values())
    relaxed, strict = ops[True], ops[False]
    # at this size the relaxed search groups the far stream's rows; without
    # it the stream is ungrouped, so it reaches the card as its entries
    assert relaxed.plan.far.row_perm is not None
    assert strict.plan.far.row_perm is None
    e = strict.operands.far.entries
    assert e.count == strict.plan.far.nnz == relaxed.plan.far.nnz
    ref = reference.Reference(mat, "cpu")
    x = torch.rand(mat.n, generator=torch.Generator().manual_seed(1)) * 2 - 1
    for t in (relaxed, strict):
        err = reference.apply_error(t.matvec(x), ref.matvec(x),
                                    ref.matvec(x, absolute=True))
        assert err < 1e-6


def test_the_float64_route_counts_no_float32_plan():
    mat = matrices.make({"generator": "hpcg27", "nx": 6, "ny": 5, "nz": 4})
    csr = ct.CSR(mat.n, mat.n, mat.indptr, mat.indices, mat.data,
                 symmetric=True)
    with trace.recording():
        op = ct.SpDMV(ct.SparseMatrix.create(csr, ct.Format.SSS),
                      dtype=np.float64, device="cpu", cache_dir="")
        op(torch.ones(mat.n, dtype=torch.float64))
    rec = trace.collect()
    assert not any(k.startswith(("tune.fp32", "sbell.")) for k in rec.counters)
    assert "fp32_plan" not in rec.named("cfs.tune")[0].attrs


@pytest.mark.parametrize("seed", [2**31 + 7, 3])
def test_the_cell_runs_correct_on_the_cpu(bench, cfg, tmp_path, seed):
    out = harness.run_cell(bench, CELL, seed, 0.2, False, device="cpu",
                           cache=str(tmp_path), cfg=_at(cfg, 10))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "apply_gflop_s"}
    assert out["checks"]["apply_err"]["value"] < 1e-6


def test_a_traced_cell_reads_the_new_metrics(bench, cfg, monkeypatch,
                                              tmp_path):
    """A ``--trace 1`` run at a CPU size, the profiler's window stood in
    for by synthetic events of the far stream's kernels (the CPU has no
    device events)."""
    def record(work, tries=3, cards=1):
        work()
        return tracing.Trace(_events([("bell2_walks_kernel<1, float, 8>",
                                       0, 30),
                                      ("unperm_gather_kernel<0>", 30, 10),
                                      ("pad_x_copy", 40, 10)]), cards=cards)

    monkeypatch.setattr(tracing, "record", record)
    out = harness.run_cell(bench, CELL, 11, 0.2, True, device="cpu",
                           cache=str(tmp_path), cfg=_at(cfg, 10))
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["far_nnz_share"] > 90
    assert m["reorder_s"] > 0
    # the stand-in window holds 3 operations, 40 us of them the far
    # stream's, whatever number of applies the run traced
    traced = 3 / m["launches_per_apply.apply"]
    assert m["far_ms_per_apply.apply"] == pytest.approx(0.040 / traced)
    assert {"far_ms_per_apply.apply", "far_nnz_share", "reorder_s"} <= {
        n["name"] for n in spec.metrics_for(bench, CELL, True)}


def _events(kernels):
    """A 100-us window holding ``kernels`` (name, ts, dur) on one card."""
    ev = [{"name": tracing.WINDOW, "cat": "user_annotation", "ph": "X",
           "ts": 0, "dur": 100}]
    return ev + [{"name": f"void {name}(float const*)", "cat": "kernel",
                  "ph": "X", "ts": ts, "dur": dur, "args": {"device": 0}}
                 for name, ts, dur in kernels]


def _run(**kw):
    base = dict(kind="apply", rhs=1, iters=0, setup_s=1.0, tune_upload_s=1.0,
                window_s=1.0, done=10, host_call_s=0.0, solve_walls_s=[],
                loop_s=[], logical_nnz=100, precision="float32",
                apply_bytes=800, value_bytes=400, plan_bytes=4000,
                peak=counts.peak_for("NVIDIA H100 80GB HBM3"), traced=4)
    return harness.Run(**{**base, **kw})


def _span(name, i, t0_s, t1_s):
    return Span(name, {}, i, None, i, int(t0_s * 1e9), int(t1_s * 1e9))


READERS = ["far_ms_per_apply.apply", "far_nnz_share", "reorder_s"]


def test_the_new_readers_on_synthetic_records():
    tr = tracing.Trace(_events([
        ("bell2_walks_kernel<1, float, 8>", 0, 20),
        ("unperm_gather_kernel<0>", 20, 4),
        ("bell2_entries_kernel<1, float>", 24, 4),
        ("bell2_spmv_kernel<true, 1, double, 1, false, double>", 28, 12),
        ("sdia_sym_kernel<float, 1>", 40, 30),
        ("Memcpy DtoD (Device -> Device)", 70, 10)]))
    setup = Record([_span("cfs.plan.reorder", 1, 2.0, 4.5),
                    _span("cfs.tune", 2, 0.0, 10.0)],
                   {"tune.fp32_nnz": 1000, "tune.fp32_far_nnz": 960})
    run = _run(trace=tr, setup_record=setup, window_record=Record([], {}))
    read = {name: spec.reader(name) for name in READERS}
    # 40 us of the far stream's kernels over the window's 4 applies
    assert read["far_ms_per_apply.apply"](run) == pytest.approx(0.010)
    assert read["far_nnz_share"](run) == pytest.approx(96.0)
    assert read["reorder_s"](run) == pytest.approx(2.5)


def test_the_new_readers_read_nothing_where_their_data_are_absent():
    read = {name: spec.reader(name) for name in READERS}
    bare = _run(trace=None)
    assert all(read[name](bare) is None for name in READERS)
    # a trace without the far stream's kernels, a set-up without the
    # float32 plan's counters or the reordering (a float64 plan)
    other = _run(trace=tracing.Trace(_events([("sdia_sym_kernel<double, 1>",
                                               0, 50)])),
                 setup_record=Record([_span("cfs.tune", 1, 0, 1)],
                                     {"plancache.hits": 1}))
    assert all(read[name](other) is None for name in READERS)
    cg = _run(kind="cg", trace=tracing.Trace(_events([
        ("bell2_walks_kernel<1, float, 8>", 0, 20)])))
    assert read["far_ms_per_apply.apply"](cg) is None
    zero = _run(setup_record=Record([], {"tune.fp32_nnz": 0,
                                         "tune.fp32_far_nnz": 0}))
    assert read["far_nnz_share"](zero) is None
