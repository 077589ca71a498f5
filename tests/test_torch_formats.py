"""Plan parity: the port's host planners against the reference's.

The PyTorch port carries jax-free copies of the reference's planners
(``formats/``, ``native/``, ``utils/proxies.py``), because the card's
machine has no JAX. These tests hold the copies byte-identical: the same
input gives plans whose every array field has equal dtype, shape and
bytes, and whose scalar fields are equal — so any parity failure further
down points at a kernel or an applier, never at the plan.
"""

import dataclasses

import numpy as np
import pytest

import __graft_entry__
import chip_smoke
from cfs_spmv_tpu.formats import bsr as ref_bsr
from cfs_spmv_tpu.formats import sdia as ref_sdia
from cfs_spmv_tpu.formats.bell2 import build_general_plan as ref_general
from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_build
from cfs_spmv_tpu.tuning.tune import _tune_fp64_df as ref_tune_fp64
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu.utils.platform import Format as RefFormat
from cfs_spmv_tpu_torch.formats import bsr
from cfs_spmv_tpu_torch.formats import sdia as port_sdia
from cfs_spmv_tpu_torch.formats.bell2 import build_general_plan
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops.bell2_df import split_df
from cfs_spmv_tpu_torch.tuning.tune import build_fp64_plan
from cfs_spmv_tpu_torch.utils import proxies


def port_csr(ref):
    """The port's CSR holding the same arrays as a reference CSR."""
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


def assert_same_plan(a, b, path="plan"):
    assert type(a).__name__ == type(b).__name__, path
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        where = f"{path}.{f.name}"
        if isinstance(va, np.ndarray):
            assert isinstance(vb, np.ndarray), where
            assert va.dtype == vb.dtype, (where, va.dtype, vb.dtype)
            assert va.shape == vb.shape, (where, va.shape, vb.shape)
            assert va.tobytes() == vb.tobytes(), where
        elif dataclasses.is_dataclass(va):
            assert_same_plan(va, vb, where)
        else:
            assert va == vb, (where, va, vb)
            assert type(va) is type(vb) or va is None, where


def _flagship():
    return __graft_entry__._flagship()


CASES = {
    "flagship": (_flagship, None),
    "cant": (lambda: ref_proxies.cant_proxy(n=4096),
             lambda: proxies.cant_proxy(n=4096)),
    "stencil27": (lambda: ref_proxies.stencil27(g=12),
                  lambda: proxies.stencil27(g=12)),
    "audikw": (lambda: ref_proxies.audikw_proxy(nb=1000),
               lambda: proxies.audikw_proxy(nb=1000)),
    "near_band_paired": (
        lambda: ref_proxies.near_band_paired(n=8000, n_diags=48,
                                             max_off=400, seed=3),
        lambda: proxies.near_band_paired(n=8000, n_diags=48, max_off=400,
                                         seed=3),
    ),
}


@pytest.mark.parametrize("paired", ["auto", "force"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plans_byte_identical(name, paired, monkeypatch):
    """Every array and scalar field of the symmetric plan — the far
    stream and the SDIA stream included — matches the reference's, under
    the default cost-gated pairing and with pairing forced (the paired
    stream the port does not run yet is still planned identically)."""
    monkeypatch.setenv("CFS_PAIRED", paired)
    ref_gen, port_gen = CASES[name]
    ref_csr = ref_gen()
    if port_gen is not None:
        # the copied generator yields the same matrix
        assert_same_plan(port_gen(), port_csr(ref_csr), "csr")
    ref_plan = ref_build(ref_csr, dtype=np.float32)
    plan = build_sbell_plan(port_csr(ref_csr), dtype=np.float32)
    assert_same_plan(plan, ref_plan)
    if paired == "auto":
        # the cost gate routes every headline shape to one-sided streams
        assert plan.nnz_paired == 0


def _expanded(gen):
    return lambda: RefCSR.from_coo(gen().to_coo().expand_symmetric())


def _rect():
    return RefCSR.from_coo(
        RefCOO.random(700, 500, 4.0, seed=1, dtype=np.float32)
    )


GENERAL = {
    "general_asym": lambda: ref_proxies.general_asym(g=12),
    "flagship_expanded": _expanded(_flagship),
    "audikw_expanded": _expanded(lambda: ref_proxies.audikw_proxy(nb=1000)),
    "rectangular": _rect,
}


@pytest.mark.parametrize("dia", [True, False])
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_plans_byte_identical(name, dia):
    """The general path's plan (``build_general_plan``), with the
    signed-offset diagonal peel on and off, matches the reference's."""
    ref_csr = GENERAL[name]()
    if name == "general_asym":
        assert_same_plan(proxies.general_asym(g=12), port_csr(ref_csr), "csr")
    ref_plan = ref_general(ref_csr, dtype=np.float32, dia=dia)
    plan = build_general_plan(port_csr(ref_csr), dtype=np.float32, dia=dia)
    assert_same_plan(plan, ref_plan)
    if dia and name == "general_asym":
        assert 0 in plan.dia.offsets and min(plan.dia.offsets) < 0


@pytest.mark.parametrize("name", ["cant", "flagship"])
def test_mirrored_sdia_plans_byte_identical(name, monkeypatch):
    """Past ``SDIA_SYM_ROWS_MAX`` the symmetric planner mirrors the
    diagonals into signed offsets: the same plan on both sides."""
    monkeypatch.setattr(ref_sdia, "SDIA_SYM_ROWS_MAX", 100)
    monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)
    ref_csr = CASES[name][0]()
    ref_plan = ref_build(ref_csr, dtype=np.float32)
    plan = build_sbell_plan(port_csr(ref_csr), dtype=np.float32)
    assert_same_plan(plan, ref_plan)
    assert min(plan.dia.offsets) < 0


@pytest.mark.parametrize("name,dia", [("near_band_paired", True),
                                      ("cant", False)])
def test_paired_plans_four_windows_byte_identical(name, dia, monkeypatch):
    """Forced pairing with four transpose windows (the cant band without
    its diagonal peel pairs whole)."""
    monkeypatch.setenv("CFS_PAIRED", "force")
    ref_csr = CASES[name][0]()
    ref_plan = ref_build(ref_csr, dtype=np.float32, transpose_windows=4,
                         dia=dia)
    plan = build_sbell_plan(port_csr(ref_csr), dtype=np.float32,
                            transpose_windows=4, dia=dia)
    assert_same_plan(plan, ref_plan)
    assert plan.nnz_paired > 0 and plan.transpose_windows == 4


@pytest.mark.parametrize("name", ["audikw", "general_asym", "flagship"])
def test_bsr_containers_byte_identical(name):
    """``Format.BSR``'s host container: the same block size and arrays."""
    gen = {"audikw": CASES["audikw"][0], "flagship": _flagship,
           "general_asym": GENERAL["general_asym"]}[name]
    ref_csr = gen()
    csr = port_csr(ref_csr)
    b = bsr.detect_block_size(csr)
    assert b == ref_bsr.detect_block_size(ref_csr)
    assert_same_plan(bsr.BSR.from_csr(csr, b),
                     ref_bsr.BSR.from_csr(ref_csr, b), "bsr")
    assert_same_plan(bsr.BSR.from_csr(csr, b).to_csr(), csr, "csr")


def test_smoke_flagship_matches_reference_generator():
    """``chip_smoke.flagship`` (written against the port's COO/CSR) is the
    reference's ``__graft_entry__._flagship``."""
    for kw in ({}, dict(n=2048, deg=32, seed=3)):
        assert_same_plan(chip_smoke.flagship(**kw),
                         port_csr(__graft_entry__._flagship(**kw)), "csr")


def _fp64_band_plus_tail():
    """A symmetric band plus a scattered strict-lower tail."""
    rng = np.random.default_rng(14)
    n = 4096
    band = RefCOO.random(n, n, 10.0, symmetric=True, bandwidth=8, seed=15,
                         dtype=np.float64)
    r = rng.integers(1, n, 2000)
    c = (r - rng.integers(1, 900, 2000)).clip(0)
    keep = r != c
    return RefCSR.from_coo(RefCOO(
        n, n, np.concatenate([band.row, r[keep]]),
        np.concatenate([band.col, c[keep]]),
        np.concatenate([band.val, rng.uniform(-1, 1, keep.sum())]),
        symmetric=True).canonicalize())


def _fp64_scattered():
    """One dense row among short ones: the planner groups rows by degree."""
    rng = np.random.default_rng(4)
    n = 4096
    row = np.concatenate([np.repeat(np.arange(n, dtype=np.int64), 3),
                          np.full(600, 17, np.int64)])
    col = rng.integers(0, n, len(row))
    return RefCSR.from_coo(RefCOO(
        n, n, row, col, rng.uniform(-1, 1, len(row))).canonicalize())


#: name -> (matrix, format, diagonals peeled, residual stream, grouped)
FP64 = {
    "banded_symmetric": (lambda: RefCSR.from_coo(RefCOO.random(
        5000, 5000, 14.0, symmetric=True, bandwidth=16, seed=12,
        dtype=np.float64)), "SSS", True, False, False),
    "band_plus_tail": (_fp64_band_plus_tail, "SSS", True, True, True),
    "scattered_grouped": (lambda: RefCSR.from_coo(RefCOO.random(
        3000, 3000, 6.0, bandwidth=100, seed=1, dtype=np.float64)),
        "CSR", False, True, True),
    "scattered_deep": (_fp64_scattered, "CSR", False, True, False),
    "rectangular": (lambda: RefCSR.from_coo(RefCOO.random(
        900, 1400, 4.0, bandwidth=200, seed=10, dtype=np.float64)),
        "CSR", False, True, True),
}


@pytest.mark.parametrize("name", sorted(FP64))
def test_fp64_plans_match_reference(name):
    """The float64 plan carried across: every index field and geometry
    scalar of the port's plan equals the plan inside the reference's
    ``_tune_fp64_df`` byte for byte, the diagonal planes (both float64,
    the main diagonal halved) byte for byte, and the port's float64 stream
    values split into (hi, lo) are exactly the reference's two float32
    planes."""
    make, fmt, peeled, resid, grouped = FP64[name]
    ref_csr = make()
    ref_plan = ref_tune_fp64(ref_csr, RefFormat[fmt]).plan
    plan = build_fp64_plan(port_csr(ref_csr))
    assert plan.vals.dtype == np.float64 and plan.vals2 is None
    assert ref_plan.vals.dtype == np.float32
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), getattr(ref_plan, f.name)
        if f.name in ("vals", "vals2", "dia"):
            continue
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b and (type(a) is type(b) or a is None), f.name
    hi, lo = split_df(plan.vals)
    assert hi.tobytes() == ref_plan.vals.tobytes()
    if resid:
        assert lo.tobytes() == ref_plan.vals2.tobytes()
    else:  # an empty stream has no second plane
        assert ref_plan.vals2 is None and not plan.vals.any()
    assert (plan.dia is not None) == peeled
    assert (plan.nnz > 0) == resid
    assert (plan.row_perm is not None) == grouped
    if peeled:
        assert_same_plan(plan.dia, ref_plan.dia, "dia")
        assert plan.dia.vals.dtype == np.float64
        assert plan.dia.offsets[0] == 0 and min(plan.dia.offsets) == 0
        j = plan.dia.offsets.index(0)
        n = ref_csr.nrows
        main = ref_csr.data[ref_csr.indptr[1:] - 1]  # last of each row
        assert np.array_equal(plan.dia.vals[:, j].reshape(-1)[:n],
                              0.5 * main)


def _communities():
    """Tiles in two interleaved communities (tile t in community t % 2),
    as ``tests/test_dist.py``'s cluster test builds them."""
    Tt, n = 16, 16 * 128
    rng = np.random.default_rng(30)
    rows, cols = [], []
    for t in range(Tt):
        comm_tiles = np.arange(t % 2, Tt, 2)
        rows.append(t * 128 + rng.integers(0, 128, 600))
        ct = comm_tiles[rng.integers(0, len(comm_tiles), 600)]
        cols.append(ct * 128 + rng.integers(0, 128, 600))
    r = np.concatenate(rows + [np.arange(n)])
    c = np.concatenate(cols + [np.arange(n)])
    keep = r >= c
    return RefCSR.from_coo(RefCOO(n, n, r[keep], c[keep], rng.uniform(
        0.5, 1.5, keep.sum()), symmetric=True).canonicalize())


PARTITIONED = {
    "communities": _communities,
    "cant": lambda: ref_proxies.cant_proxy(n=4096),
    "audikw": lambda: ref_proxies.audikw_proxy(nb=1000),
    "general_ragged": lambda: RefCSR.from_coo(RefCOO.random(
        3000, 3000, 6.0, bandwidth=900, seed=4, dtype=np.float32)),
}


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(PARTITIONED))
def test_partition_and_cluster_copies_match_reference(name, ndev):
    """The host copies ``tuning/partition.py`` and ``tuning/cluster.py``
    give the reference's tile histograms, bounds, imbalance, quotient
    graph, cluster order, cut and cluster assignment (permutation and
    permuted matrix)."""
    from cfs_spmv_tpu.tuning import cluster as ref_cluster
    from cfs_spmv_tpu.tuning import partition as ref_partition
    from cfs_spmv_tpu_torch.tuning import cluster, partition

    ref_csr = PARTITIONED[name]()
    csr = port_csr(ref_csr)
    T = -(-csr.nrows // 128)
    hist = partition.tile_nnz_histogram(csr.indptr, T)
    same = lambda a, b: (a.dtype == b.dtype  # noqa: E731
                         and a.tobytes() == b.tobytes())
    assert same(hist, ref_partition.tile_nnz_histogram(ref_csr.indptr, T))
    for fn in ("partition_tiles_by_nnz",):
        assert same(getattr(partition, fn)(hist, ndev),
                    getattr(ref_partition, fn)(hist, ndev))
    assert same(partition.partition_tiles_by_count(T, ndev),
                ref_partition.partition_tiles_by_count(T, ndev))
    assert (partition.estimate_imbalance(hist[: ndev + 1])
            == ref_partition.estimate_imbalance(hist[: ndev + 1]))
    for a, b in zip(cluster.tile_quotient_graph(csr),
                    ref_cluster.tile_quotient_graph(ref_csr)):
        assert same(a, b)
    order = cluster.cluster_tile_order(csr, ndev)
    assert same(order, ref_cluster.cluster_tile_order(ref_csr, ndev))
    bounds = partition.partition_tiles_by_nnz(hist, ndev)
    tile_of = np.empty(T, np.int64)
    tile_of[order] = np.arange(T)
    assert (cluster.cut_weight(csr, bounds, tile_of)
            == ref_cluster.cut_weight(ref_csr, bounds, tile_of))
    got = cluster.choose_cluster_assignment(csr, ndev)
    want = ref_cluster.choose_cluster_assignment(ref_csr, ndev)
    assert (got is None) == (want is None)
    if got is not None:
        assert same(got[0], want[0])
        assert_same_plan(got[1], want[1], "permuted")
    if name == "communities" and ndev == 2:
        assert got is not None  # the case the clustering exists for
