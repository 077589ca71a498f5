"""The port's distributed layer (``cfs_spmv_tpu_torch.parallel``) against
the reference's, on the CPU.

The cases are those of ``tests/test_dist.py``, with the same matrices
from the same seeds, in float32 on both sides (the reference's default
``DistSpDMV`` type). The reference runs on its 8 virtual CPU devices
(``tests/conftest.py``), its kernels in interpret mode; the port runs P
shards on one CPU mesh (``make_mesh(P, device="cpu")``), its kernel
wrappers through their plain twins. Each case checks:

- the host decisions: ``bounds``, ``real``, ``shard_rows``, ``BT``,
  ``K``, the resolved ``comm``, ``halo_rows``, ``dia_offsets``,
  ``dia_mirror``, ``far_nnz``, ``nnz_full`` and ``perm`` are the
  reference's;
- the plans: each shard's arrays are byte-identical to the reference's
  (D, ...) stacks sliced back to that shard's chunks;
- y: within ``allclose_spmv`` (float32, the backward-error scale) of the
  float64 host oracle ``CSR.spmv_host`` and of the reference
  ``DistSpDMV``'s y (an SpMM case: Y at B = 11, two plane groups, column
  by column).

The reference compiles one interpreted program per operator (2-6 s on
this CPU), so its y is computed once per module and operator: a case
whose operator another case already holds (the same matrix under
another ``comm``, P or assignment) is held to that case's reference y.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.ops.bell2_kernel import meta_word
from cfs_spmv_tpu.parallel import scaling as ref_scaling
from cfs_spmv_tpu.parallel.dist import DistSpDMV as RefDist
from cfs_spmv_tpu.parallel.mesh import make_mesh as ref_mesh
from cfs_spmv_tpu_torch import native
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.parallel import scaling
from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
from cfs_spmv_tpu_torch.parallel.mesh import get_devices, make_mesh
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
from tests.conftest import random_x

#: right-hand sides of the SpMM cases: a group of 8 planes and one of 3
B = 11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_csr(ref):
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


# --- the matrices of tests/test_dist.py, same sizes and seeds ----------
def _random(n, per_row, seed, symmetric=False, bandwidth=None):
    return RefCSR.from_coo(RefCOO.random(
        n, n, per_row, symmetric=symmetric, bandwidth=bandwidth, seed=seed,
        dtype=np.float64))


def _band(n, half_bw, seed, scat=0.0, scat_seed=None, holes=None):
    """Symmetric band of ``half_bw`` lower diagonals plus a diagonal in
    [1, 2), optionally a scattered symmetric residual, optionally with
    the rows ``holes`` = (lo, hi) left empty."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r, c = [rows[keep]], [cols[keep]]
    v = [rng.uniform(-1, 1, keep.sum())]
    if scat:
        s = RefCOO.random(n, n, scat, symmetric=True, seed=scat_seed,
                          dtype=np.float64)
        r, c, v = r + [s.row], c + [s.col], v + [s.val]
    r = np.concatenate(r + [np.arange(n)]).astype(np.int64)
    c = np.concatenate(c + [np.arange(n)]).astype(np.int64)
    v = np.concatenate(v + [rng.uniform(1, 2, n)])
    if holes is not None:
        out = ((r >= holes[0]) & (r < holes[1])) | (
            (c >= holes[0]) & (c < holes[1]))
        r, c, v = r[~out], c[~out], v[~out]
    return RefCSR.from_coo(
        RefCOO(n, n, r, c, v, symmetric=True).canonicalize())


def _scattered(n, per_row, seed):
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    col = rng.integers(0, n, per_row * n)
    return RefCSR.from_coo(RefCOO(n, n, row, col, rng.uniform(
        -1, 1, per_row * n)).canonicalize())


def _communities():
    """Two communities whose tiles interleave (tile t in community
    t % 2), edges inside a community only."""
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
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 1.5, len(r))
    return RefCSR.from_coo(RefCOO(n, n, r, c, v, symmetric=True)
                           .canonicalize())


def _spd():
    """The SPD system of ``test_cg_over_dist_operator`` (float32 values)."""
    rng = np.random.default_rng(0)
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), 6)
    cols = np.clip(rows - rng.integers(1, 40, n * 6), 0, n - 1)
    keep = cols < rows
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate([rng.uniform(-1, 1, keep.sum()),
                        np.full(n, 15.0)]).astype(np.float32)
    return RefCSR.from_coo(RefCOO(n, n, r, c, v, symmetric=True)
                           .canonicalize())


MATRICES = {
    "general": lambda: _random(2100, 7.0, 1, bandwidth=200),
    "symmetric": lambda: _random(1500, 6.0, 2, True, 120),
    "uneven": lambda: _random(530, 4.0, 4, bandwidth=60),
    "dia": lambda: _band(4096, 6, 7),
    "mixed": lambda: _band(3000, 4, 8, 2.0, 9),
    "ring_general": lambda: _random(1700, 6.0, 11, bandwidth=400),
    "ring_symmetric": lambda: _random(1700, 6.0, 11, True, 400),
    "ring_dia": lambda: _band(4096, 5, 13, 1.0, 14),
    "spmm": lambda: _random(1300, 5.0, 17, True, 150),
    "spmm_general": lambda: _random(900, 4.0, 19, bandwidth=200),
    "halo_banded": lambda: _random(4096, 6.0, 21, bandwidth=150),
    "halo_symmetric": lambda: _random(3072, 5.0, 22, True, 120),
    "scattered": lambda: _scattered(2048, 4, 24),
    "scattered_small": lambda: _scattered(1024, 3, 25),
    "communities": _communities,
    "spd": _spd,
}

#: name -> (matrix, P, DistSpDMV keywords, environment, RHS count (0:
#: SpMV), the case whose reference y this one is held to (None: its own))
CASES = {
    "general_p2": ("general", 2, {}, {}, 0, None),
    "general_p8": ("general", 8, {}, {}, 0, "general_p2"),
    "symmetric_p8": ("symmetric", 8, {}, {}, 0, None),
    "symmetric_p4": ("symmetric", 4, {}, {}, 0, "symmetric_p8"),
    "uneven_p8": ("uneven", 8, {}, {}, 0, None),
    "dia_p8": ("dia", 8, dict(dia_min_count=8), {}, 0, None),
    # shards past the diagonal gate store mirrored planes (sdia_gen)
    "dia_mirrored_p8": ("dia", 8, dict(dia_min_count=8),
                        {"CFS_DIST_SDIA_ROWS_MAX": "256"}, 0, "dia_p8"),
    "mixed_p8": ("mixed", 8, dict(dia_min_count=8), {}, 0, None),
    "gather_general_p8": ("ring_general", 8, dict(comm="gather"), {}, 0,
                          None),
    "ring_general_p8": ("ring_general", 8, dict(comm="ring"), {}, 0,
                        "gather_general_p8"),
    "ring_general_p2": ("ring_general", 2, dict(comm="ring"), {}, 0,
                        "gather_general_p8"),
    "gather_symmetric_p8": ("ring_symmetric", 8, dict(comm="gather"), {}, 0,
                            None),
    "ring_symmetric_p8": ("ring_symmetric", 8, dict(comm="ring"), {}, 0,
                          "gather_symmetric_p8"),
    "ring_dia_p8": ("ring_dia", 8, dict(dia_min_count=8, comm="ring"), {},
                    0, None),
    "spmm_gather_p8": ("spmm", 8, dict(comm="gather", dia_min_count=8), {},
                       B, None),
    "spmm_ring_p8": ("spmm", 8, dict(comm="ring", dia_min_count=8), {}, B,
                     "spmm_gather_p8"),
    "spmm_general_p8": ("spmm_general", 8, {}, {}, B, None),
    "halo_banded_p8": ("halo_banded", 8, {}, {}, 0, None),
    "halo_banded_gather_p8": ("halo_banded", 8, dict(comm="gather"), {}, 0,
                              "halo_banded_p8"),
    "halo_symmetric_mm_p8": ("halo_symmetric", 8, {}, {}, B, None),
    "halo_fallback_p8": ("scattered", 8, {}, {}, 0, None),
    "halo_unviable_p8": ("scattered_small", 8, dict(comm="halo"), {}, 0,
                         None),
    "cluster_p2": ("communities", 2, dict(assign="cluster"), {}, 0, None),
    "contiguous_p2": ("communities", 2, {}, {}, 0, "cluster_p2"),
    "spd_p4": ("spd", 4, {}, {}, 0, None),
}

_MATRIX_CACHE: dict = {}
_REF_CACHE: dict = {}


def matrix(name):
    if name not in _MATRIX_CACHE:
        _MATRIX_CACHE[name] = MATRICES[name]()
    return _MATRIX_CACHE[name]


def inputs(csr, rhs):
    if rhs:
        return np.random.default_rng(18).uniform(
            1, 2, (csr.nrows, rhs)).astype(np.float32)
    return random_x(csr.nrows, np.float32)


def build(case, monkeypatch):
    """(reference DistSpDMV, port DistSpDMV, host CSR) of ``case``, built
    under its environment."""
    mname, P, kw, env, _, _ = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ("dsp", case) not in _REF_CACHE:
        _REF_CACHE["dsp", case] = RefDist(matrix(mname), ref_mesh(P), **kw)
    port = DistSpDMV(port_csr(matrix(mname)), make_mesh(P, device="cpu"),
                     **kw)
    return _REF_CACHE["dsp", case], port, matrix(mname)


def ref_y(case, monkeypatch):
    """The reference's y (or Y, column by column through its SpMV
    program) for the inputs of ``case``, from the case that holds its
    operator; computed once per module."""
    rhs, donor = CASES[case][4], CASES[case][5] or case
    key = ("y", donor, rhs)
    if key not in _REF_CACHE:
        ref, _, csr = build(donor, monkeypatch)
        x = inputs(csr, rhs)
        if rhs:
            _REF_CACHE[key] = np.stack(
                [np.asarray(ref(x[:, b])) for b in range(rhs)], axis=1)
        else:
            _REF_CACHE[key] = np.asarray(ref(x))
    return _REF_CACHE[key]


def decisions(d):
    return dict(
        bounds=np.asarray(d.bounds).tolist(),
        real=[tuple(int(v) for v in r) for r in d.real],
        shard_rows=d.shard_rows, BT=d.BT, K=d.K,
        K_ring=getattr(d, "K_ring", None), comm=d.comm,
        halo_rows=d.halo_rows,
        dia_offsets=tuple(getattr(d, "dia_offsets", ())),
        dia_mirror=bool(getattr(d, "dia_mirror", False)),
        far_nnz=d.far_nnz, nnz_full=d.nnz_full,
        perm=None if d.perm is None else np.asarray(d.perm).tolist(),
        ndev=d.ndev, nrows=d.nrows, symmetric=d.symmetric,
    )


def same(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), where


def same_stream(plan, stack, d, where):
    """A port shard's one-sided plan against shard d of the reference's
    stack (vals, packed, meta or meta words, step_block)."""
    vals, packed, meta, steps = (np.asarray(a)[d] for a in stack)
    C, G = plan.meta.shape[0], len(plan.step_block)
    same(plan.vals, vals[:C * 8], where + ".vals")
    same(plan.packed, packed[:C * 8], where + ".packed")
    if meta.ndim == 1:  # the reference's word path: the same meta, packed
        same(np.asarray(meta_word(plan.meta), np.int32), meta[:C],
             where + ".meta_word")
    else:
        same(plan.meta, meta[:C], where + ".meta")
    same(plan.step_block, steps[:G], where + ".step_block")
    # the stack's padding is what the reference's SPMD program needs
    assert not np.asarray(vals[C * 8:]).any(), where


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_decisions_are_the_reference_s(case, monkeypatch):
    ref, port, _ = build(case, monkeypatch)
    assert decisions(port) == decisions(ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_plans_byte_identical(case, monkeypatch):
    ref, port, _ = build(case, monkeypatch)
    assert len(port.plans) == ref.ndev
    ring = port.comm == "ring"
    for d, sp in enumerate(port.plans):
        if ring:
            assert sp.far is None and len(sp.ring) == ref.ndev
            for k, p in enumerate(sp.ring):
                same_stream(p, ref._far[k], d, f"shard {d} ring step {k}")
        else:
            assert sp.ring is None
            same_stream(sp.far, ref._far, d, f"shard {d} far")
        if not port.symmetric:
            assert sp.paired is None and ref._paired is None
            continue
        p = sp.paired
        pv, pp, pm, ps = (np.asarray(a)[d] for a in ref._paired)
        C, G = p.meta.shape[0], len(p.step_block)
        same(p.vals, pv[:C * 8], f"shard {d} paired.vals")
        same(p.packed, pp[:C * 8], f"shard {d} paired.packed")
        same(p.meta, pm[:C], f"shard {d} paired.meta")
        same(p.step_block, ps[:G], f"shard {d} paired.step_block")
        same(sp.diag, np.asarray(ref._diag)[d], f"shard {d} diag")
        if ref._dia is None:
            assert sp.dia is None
        else:
            same(sp.dia, np.asarray(ref._dia)[d], f"shard {d} dia")
        if p.far is not None:  # the paired plan's residual
            same_stream(p.far, ref._pfar, d, f"shard {d} paired.far")
        elif ref._pfar is not None:  # the reference pads with an empty plan
            assert not np.asarray(ref._pfar[0])[d].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_y_matches_reference_and_oracle(case, monkeypatch):
    _, port, csr = build(case, monkeypatch)
    rhs = CASES[case][4]
    x = inputs(csr, rhs)
    y = port(x)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    y = y.numpy()
    y_ref = ref_y(case, monkeypatch)
    npr = max(csr.to_coo().nnz_full / csr.nrows, 1.0)
    cols = [(x, y, y_ref)] if not rhs else [
        (x[:, b], y[:, b], y_ref[:, b]) for b in range(rhs)]
    for xb, yb, rb in cols:
        xb = xb.astype(np.float64)
        scale = csr.spmv_host(xb, absolute=True)
        assert allclose_spmv(yb, csr.spmv_host(xb), np.float32,
                             nnz_per_row=npr, scale=scale)
        assert allclose_spmv(yb, rb, np.float32, nnz_per_row=npr,
                             scale=scale)


def test_case_paths():
    """The cases reach the paths they are named for (as the reference's
    own tests assert)."""
    # these builds reuse nothing: plain constructions on the CPU mesh
    def port(case):
        mname, P, kw, _, _, _ = CASES[case]
        return DistSpDMV(port_csr(matrix(mname)),
                         make_mesh(P, device="cpu"), **kw)

    assert len(port("dia_p8").dia_offsets) >= 6
    assert port("halo_banded_p8").comm == "halo"
    assert 0 < port("halo_banded_p8").halo_rows <= port(
        "halo_banded_p8").shard_rows
    assert port("halo_symmetric_mm_p8").comm == "halo"
    assert port("halo_fallback_p8").comm == "gather"
    assert port("uneven_p8").real[-1][1] == 0  # an empty shard
    c, d = port("cluster_p2"), port("contiguous_p2")
    assert c.perm is not None and c.far_fraction < 0.5 * d.far_fraction
    assert not port("dia_p8").dia_mirror


def test_mirrored_diagonals(monkeypatch):
    monkeypatch.setenv("CFS_DIST_SDIA_ROWS_MAX", "256")
    _, port, _ = build("dia_mirrored_p8", monkeypatch)
    assert port.dia_mirror and min(port.dia_offsets) < 0
    assert all(sh.near.dia_mirrored for sh in port.shards)


@pytest.mark.parametrize("P", [8, 1])
def test_unviable_halo_request_warns(P, monkeypatch, caplog):
    """An explicit halo request the structure (P = 8) or the mesh (one
    device) cannot serve falls back to gather, with the reference's
    warning."""
    caplog.set_level("WARNING", logger="cfs_spmv_tpu_torch")
    if P == 8:
        _, port, _ = build("halo_unviable_p8", monkeypatch)
    else:
        port = DistSpDMV(port_csr(matrix("halo_banded")),
                         make_mesh(1, device="cpu"), comm="halo")
    assert port.comm == "gather" and port.halo_rows == 0
    assert "falling back to gather" in caplog.text


@pytest.mark.parametrize("mname,P", [("dia", 8), ("mixed", 8),
                                     ("ring_symmetric", 4)])
def test_numpy_split_matches_native(mname, P, monkeypatch):
    """The NumPy shard split (no native library) makes the native
    split's plans and decisions."""
    if not native.available():
        pytest.skip("the native library did not build here")
    kw = dict(dia_min_count=8)
    a = DistSpDMV(port_csr(matrix(mname)), make_mesh(P, device="cpu"), **kw)
    monkeypatch.setattr(native, "dist_sym_count", lambda *a, **k: None)
    b = DistSpDMV(port_csr(matrix(mname)), make_mesh(P, device="cpu"), **kw)
    assert decisions(a) == decisions(b)
    for pa, pb in zip(a.plans, b.plans):
        for f in ("vals", "packed", "meta", "step_block"):
            same(getattr(pa.paired, f), getattr(pb.paired, f), f)
        for x, y in ((pa.dia, pb.dia), (pa.diag, pb.diag)):
            if x is None:
                assert y is None
            else:
                same(x, y, "dia")
        for f in ("vals", "packed", "meta", "step_block"):
            same(getattr(pa.far, f), getattr(pb.far, f), "far." + f)


def test_one_block_trap_absent_rows(monkeypatch):
    """A matrix with an absent row range on 8 shards over 8-tile output
    blocks, one shard several blocks tall, every stream output allocated
    poisoned with NaN: y (and Y at B = 11) is the unpoisoned y bit for
    bit, the absent rows read exactly 0, and the reference makes the same
    decisions and plans."""
    csr = _band(4096, 6, 7, holes=(1100, 3000))
    ref = RefDist(csr, ref_mesh(8), comm="gather", dia_min_count=8)
    port = DistSpDMV(port_csr(csr), make_mesh(8, device="cpu"),
                     comm="gather", dia_min_count=8)
    assert decisions(port) == decisions(ref)
    assert port.BT == 8 and port.shard_rows > 8 * 128
    x = inputs(csr, 0)
    X = inputs(csr, B)
    y0, Y0 = port(x), port(X)
    out_buffer = bk._out_buffer

    def poisoned(out, shape, dev, dtype=torch.float32):
        if out is None:
            return torch.full(shape, float("nan"), dtype=dtype, device=dev)
        return out_buffer(out, shape, dev, dtype)

    monkeypatch.setattr(bk, "_out_buffer", poisoned)
    y, Y = port(x), port(X)
    assert torch.equal(y, y0) and torch.equal(Y, Y0)
    assert torch.equal(y[1100:3000], torch.zeros(1900))
    assert torch.equal(Y[1100:3000], torch.zeros(1900, B))
    scale = csr.spmv_host(x.astype(np.float64), absolute=True)
    assert allclose_spmv(y.numpy(), csr.spmv_host(x.astype(np.float64)),
                         np.float32, nnz_per_row=13, scale=scale)


def test_cg_over_dist_operator(monkeypatch):
    """CG over the 4-shard operator converges on the SPD system, as in
    the reference's test, and its solution's product is the reference
    operator's."""
    from cfs_spmv_tpu_torch.models import solvers

    ref, port, csr = build("spd_p4", monkeypatch)
    b = np.random.default_rng(0).uniform(1, 2, csr.nrows).astype(np.float32)
    x, rnorm, hist = solvers.cg(port, b, iters=40)
    res = b - port(x).numpy()
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-5
    assert x.dtype == torch.float32 and hist.shape == (40,)
    xs = x.numpy()
    scale = csr.spmv_host(xs.astype(np.float64), absolute=True)
    assert allclose_spmv(port(xs).numpy(), np.asarray(ref(xs)), np.float32,
                         nnz_per_row=12, scale=scale)


def test_pure_apply_and_timing(monkeypatch):
    """``as_pure`` takes the operator as it takes a tuned matrix (the
    multi-RHS applier for a 2-D X, encode/decode of the cluster
    permutation) and ``time_matvec`` times it."""
    from cfs_spmv_tpu_torch.utils.timing import as_pure, time_matvec

    _, port, csr = build("cluster_p2", monkeypatch)
    X = inputs(csr, 3)
    fn, ops, encode, decode = as_pure(port, X)
    Xt = torch.from_numpy(X)
    Y = decode(fn(ops, encode(Xt)))
    assert torch.equal(Y, port(X))
    Yp = decode(fn(ops, encode(Xt), plain=True))
    assert torch.equal(Yp, Y)  # the CPU runs the twins either way
    assert time_matvec(port, X[:, 0], iters=2, repeats=1) > 0


def test_validation():
    csr = port_csr(_random(300, 3.0, 5))
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError):
        DistSpDMV(csr, mesh, comm="nope")
    with pytest.raises(ValueError):
        DistSpDMV(csr, mesh, assign="nope")
    dsp = DistSpDMV(csr, mesh)
    with pytest.raises(ValueError):
        dsp(np.ones(299))
    with pytest.raises(ValueError):
        dsp(np.ones((299, 2)))
    rect = CSR(300, 301, csr.indptr, csr.indices, csr.data, False)
    with pytest.raises(NotImplementedError):
        DistSpDMV(rect, mesh)


def test_mesh_defaults_to_the_card(monkeypatch):
    """``make_mesh`` and ``get_devices`` default to the node's cards and
    raise where CUDA is absent; an indexed device or the CPU holds
    ``num`` shards; ``CFS_NUM_DEVICES`` sets that count."""
    from cfs_spmv_tpu_torch.utils.config import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh, get_devices, lambda: make_mesh(2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    m = make_mesh(4, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 4 and m.single_device
    assert m.shape == {"rows": 4}
    m2 = make_mesh(4, rhs=2, device="cpu")
    assert m2.shape == {"rows": 2, "rhs": 2} and len(m2.row_devices) == 2
    with pytest.raises(ValueError):
        make_mesh(3, rhs=2, device="cpu")
    monkeypatch.setattr(config, "num_devices", 3)
    assert len(get_devices(device="cpu")) == 3
    # more cards than the node has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="only 1 available"):
        make_mesh(2)


def test_scaling_model():
    """The port's model (mirroring the reference's test): a far-fraction
    profile equal to the reference's; on an H100 chip name the NVLink and
    InfiniBand rows, and the reference's ``cpu`` row unchanged."""
    ref_csr = _random(4000, 6.0, 33, True, 300)
    csr = port_csr(ref_csr)
    fracs = []
    for nd in (2, 4, 8):
        p = scaling.far_profile(csr, nd)
        assert dataclasses.astuple(p) == dataclasses.astuple(
            ref_scaling.far_profile(ref_csr, nd))
        assert 0.0 <= p.far_fraction <= 1.0 and p.ndev == nd
        fracs.append(p.far_fraction)
    assert fracs[0] <= fracs[-1] + 1e-9
    model = scaling.scaling_model(csr, measured_nnz_s=2e11,
                                  chip="h100-sxm", step_overhead_s=0.0)
    for m in model:
        assert 0.0 < m["efficiency"] <= 1.0 and m["t_comm_s"] >= 0.0
    assert model[0]["efficiency"] > 0.5
    strong = scaling.scaling_model(
        csr, measured_nnz_s=2e11, chip="h100-sxm", mode="strong",
        ndevs=(2, 4, 8, 16), step_overhead_s=0.0)
    for m in strong:
        assert 0.0 < m["efficiency"] <= 1.0
    assert strong[0]["link"] == "nvlink"
    assert strong[-1]["link"] == "infiniband" and strong[-1]["hosts"] == 2
    # an unknown name is taken for the SXM part
    assert scaling.scaling_model(
        csr, measured_nnz_s=2e11, chip="some-gpu", ndevs=(2,)) == \
        scaling.scaling_model(csr, measured_nnz_s=2e11, ndevs=(2,))
    for mode in ("weak", "strong"):
        for comm in ("auto", "ring"):
            kw = dict(measured_nnz_s=2e11, chip="cpu", mode=mode,
                      comm=comm, ndevs=(2, 16))
            assert scaling.scaling_model(csr, **kw) == \
                ref_scaling.scaling_model(ref_csr, **kw)


@pytest.mark.parametrize("extra", [["--model"], ["--weak"], ["--rhs", "3"]])
def test_cli_bench_dist(extra, capsys, tmp_path):
    from cfs_spmv_tpu_torch.cli.bench_dist import main

    js = tmp_path / "runs.jsonl"
    assert main(["--gen", "band_small", "2", "--devices", "2", "--device",
                 "cpu", "--json", str(js), *extra]) == 0
    out = capsys.readouterr().out
    assert "devices: 1" in out and "devices: 2" in out
    assert "efficiency:" in out and "timer: eager" not in out
    if "--model" in extra:
        assert "model weak" in out and "model strong" in out
        assert "(ici)" in out  # the cpu row's links
    if "--rhs" in extra:
        assert "SpMM(3)" in out
    assert js.read_text().count("\n") == 1



@pytest.mark.parametrize("case", ["halo_banded_p8", "symmetric_p8",
                                  "ring_dia_p8", "spmm_ring_p8",
                                  "uneven_p8"])
def test_exchanges_across_devices(case, monkeypatch):
    """The exchanges of a mesh over distinct devices (``cpu:0`` ...
    ``cpu:P-1``, every tensor on the CPU: each shard's segment or halo
    window, its far x and its y in buffers on its device, filled by copies
    from x): the same y bit for bit as the one-device mesh's."""
    from cfs_spmv_tpu_torch.parallel.mesh import Mesh

    mname, P, kw = CASES[case][:3]
    _, port, csr = build(case, monkeypatch)
    cards = DistSpDMV(port_csr(matrix(mname)),
                      Mesh(tuple(torch.device("cpu", d) for d in range(P))),
                      **kw)
    assert not cards.capturable and cards.real == port.real
    x = inputs(csr, CASES[case][4])
    assert torch.equal(cards(x), port(x))
    assert cards._bufs


def test_cli_bench_dist_eager_timer(capsys, monkeypatch):
    """A mesh over several devices is timed eagerly and says so."""
    from cfs_spmv_tpu_torch.cli.bench_dist import main
    from cfs_spmv_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(Mesh, "single_device", property(lambda self: False))
    assert main(["--gen", "band_small", "2", "--devices", "2", "--device",
                 "cpu", "--rhs", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("timer: eager") == 4  # SpMV and SpMM at P = 1 and 2
