"""The float64 distributed operator (``DistSpDMV(..., dtype=np.float64)``)
against the reference's, on the CPU.

The reference's own tests run ``DistSpDMV`` in float64 with x64 on
(``tests/test_dist.py``); its shards apply the same Pallas kernels as in
float32, on float64 arrays. The cases here are those float64 cases, with
the same matrices from the same seeds (the cases of
``tests/test_torch_dist.py``, whose float32 form that file checks), plus
``paired_p4``: a near-banded matrix under ``CFS_PAIRED=force``, whose
shards run the paired stream (B5/B10) in double; the mirrored case
(``dia_mirrored_p8``) runs the signed diagonals (B6/B12) in double. The
port runs P shards on one CPU mesh, its kernel wrappers through their
plain twins. Each case checks:

- the host decisions are the reference's;
- each shard's float64 plan is byte-identical to the reference's (D, ...)
  stacks sliced back to that shard;
- y (an SpMM case: Y at B = 11, two plane groups, column by column) is
  float64 and within ``allclose_spmv`` float64 (1e-8 on the backward-error
  scale) of the float64 host oracle ``CSR.spmv_host`` and of the
  reference's float64 y.

Then the twins of B5/B10 and B6/B12 in float64, on a float64 shard's plan
arrays, against the reference's kernels run in interpret mode, into
NaN-poisoned outputs; and the one-block trap (8-tile output blocks, an
absent row range, every stream output allocated poisoned) in float64.

The reference compiles one interpreted program per operator, so its y is
computed once per module and operator, as in ``tests/test_torch_dist.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfs_spmv_tpu.ops import bell2_kernel as ref_bk
from cfs_spmv_tpu.ops import sdia_kernel as ref_sk
from cfs_spmv_tpu.parallel.dist import DistSpDMV as RefDist
from cfs_spmv_tpu.parallel.mesh import make_mesh as ref_mesh
from cfs_spmv_tpu.utils.proxies import near_band_paired as ref_nbp
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
from cfs_spmv_tpu_torch.parallel.mesh import make_mesh
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv
from tests.conftest import random_x
from tests.test_torch_dist import (
    CASES as F32_CASES,
    MATRICES as F32_MATRICES,
    B,
    _band,
    decisions,
    port_csr,
    same,
    same_stream,
)

MATRICES = {
    **F32_MATRICES,
    # near-banded, locally dense diagonals below the SDIA bar: paired
    "paired": lambda: ref_nbp(n=4096, n_diags=24, max_off=300, seed=3),
}

#: the float64 cases: name -> (matrix, P, keywords, environment, RHS count
#: (0: SpMV), the case whose reference y this one is held to); the float32
#: cases' cg system (``spd_p4``) is the reference's float32 solve
CASES = {k: v for k, v in F32_CASES.items() if k != "spd_p4"}
CASES["paired_p4"] = ("paired", 4, {}, {"CFS_PAIRED": "force"}, 0, None)
CASES["paired_mm_p4"] = ("paired", 4, {}, {"CFS_PAIRED": "force"}, B,
                         "paired_p4")

_MATRIX_CACHE: dict = {}
_REF_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def matrix(name):
    if name not in _MATRIX_CACHE:
        _MATRIX_CACHE[name] = MATRICES[name]()
    return _MATRIX_CACHE[name]


def inputs(csr, rhs):
    if rhs:
        return np.random.default_rng(18).uniform(1, 2, (csr.nrows, rhs))
    return random_x(csr.nrows, np.float64)


def build(case, monkeypatch):
    """(reference DistSpDMV, port DistSpDMV, host CSR) of ``case`` in
    float64, built under its environment."""
    mname, P, kw, env, _, _ = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if ("dsp", case) not in _REF_CACHE:
        _REF_CACHE["dsp", case] = RefDist(matrix(mname), ref_mesh(P),
                                          dtype=np.float64, **kw)
    port = DistSpDMV(port_csr(matrix(mname)), make_mesh(P, device="cpu"),
                     dtype=np.float64, **kw)
    return _REF_CACHE["dsp", case], port, matrix(mname)


def ref_y(case, monkeypatch):
    """The reference's float64 y (or Y, column by column through its SpMV
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_decisions_are_the_reference_s(case, monkeypatch):
    ref, port, _ = build(case, monkeypatch)
    assert decisions(port) == decisions(ref)
    assert port.dtype == torch.float64


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_plans_byte_identical(case, monkeypatch):
    ref, port, _ = build(case, monkeypatch)
    assert len(port.plans) == ref.ndev
    ring = port.comm == "ring"
    for d, sp in enumerate(port.plans):
        streams = list(sp.ring) if ring else [sp.far]
        for k, p in enumerate(streams):
            assert p.vals.dtype == np.float64
            assert p.row_perm is None  # no shard stream is grouped
            same_stream(p, ref._far[k] if ring else ref._far, d,
                        f"shard {d} far {k}")
        if not port.symmetric:
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
        if p.far is not None:
            assert p.far.row_perm is None
            same_stream(p.far, ref._pfar, d, f"shard {d} paired.far")
        elif ref._pfar is not None:
            assert not np.asarray(ref._pfar[0])[d].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_y_matches_reference_and_oracle(case, monkeypatch):
    _, port, csr = build(case, monkeypatch)
    rhs = CASES[case][4]
    x = inputs(csr, rhs)
    y = port(x)
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    y = y.numpy()
    y_ref = ref_y(case, monkeypatch)
    npr = max(csr.to_coo().nnz_full / csr.nrows, 1.0)
    cols = [(x, y, y_ref)] if not rhs else [
        (x[:, b], y[:, b], y_ref[:, b]) for b in range(rhs)]
    for xb, yb, rb in cols:
        scale = csr.spmv_host(xb, absolute=True)
        assert allclose_spmv(yb, csr.spmv_host(xb), np.float64,
                             nnz_per_row=npr, scale=scale)
        assert allclose_spmv(yb, rb, np.float64, nnz_per_row=npr,
                             scale=scale)


def test_cases_reach_the_double_kernels(monkeypatch):
    """The paired case pairs every shard's residual and the mirrored case
    stores signed planes: the double instances of B5/B10 and B6/B12 are
    on their paths, in float64 tensors."""
    _, paired, _ = build("paired_p4", monkeypatch)
    assert all(sh.near.has_paired and sh.near.vals.dtype == torch.float64
               for sh in paired.shards)
    _, mirrored, _ = build("dia_mirrored_p8", monkeypatch)
    assert mirrored.dia_mirror and min(mirrored.dia_offsets) < 0
    assert all(sh.near.dia_mirrored
               and sh.near.dia_vals.dtype == torch.float64
               for sh in mirrored.shards)


def test_matches_single_device_and_ring_matches_gather(monkeypatch):
    """As the reference's tests: the 8-shard float64 y against the
    single-device float64 ``SpDMV`` of the same matrix, and the ring
    against the gather within float64's gate."""
    from cfs_spmv_tpu_torch import Format, SparseMatrix, SpDMV, Tuning

    _, ring, csr = build("ring_symmetric_p8", monkeypatch)
    _, gather, _ = build("gather_symmetric_p8", monkeypatch)
    x = inputs(csr, 0)
    A = SparseMatrix.create(port_csr(csr), Format.SSS)
    y1 = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float64, device="cpu")(x)
    scale = csr.spmv_host(x, absolute=True)
    npr = csr.to_coo().nnz_full / csr.nrows
    for y in (ring(x), gather(x)):
        assert allclose_spmv(y.numpy(), y1.numpy(), np.float64,
                             nnz_per_row=npr, scale=scale)


def _paired_shard(monkeypatch):
    """Shard 1's float64 paired plan of ``paired_p4`` on the CPU, with
    its reference-side arrays, geometry keywords and padded tiles."""
    _, port, _ = build("paired_p4", monkeypatch)
    plan = port.plans[1].paired
    pd = ops.sym_to_device(plan, "cpu")
    assert pd.has_paired and pd.vals.dtype == torch.float64
    kw = dict(num_row_tiles=plan.num_row_tiles,
              chunks_per_step=plan.chunks_per_step,
              tiles_per_block=plan.tiles_per_block,
              transpose_windows=plan.transpose_windows)
    TP = -(-plan.num_row_tiles // plan.tiles_per_block) * plan.tiles_per_block
    ref_arrays = [jnp.asarray(getattr(plan, k))
                  for k in ("vals", "packed", "meta", "step_block")]
    return plan, pd, kw, TP, ref_arrays


def test_sbell_twins_float64_match_reference(monkeypatch):
    """B5 and B10 (B = 11) in float64 on a float64 paired shard, into
    NaN-poisoned outputs, against the reference's kernels (interpret
    mode) on the same float64 arrays; each plane of B10 is B5's."""
    plan, pd, kw, TP, ref_arrays = _paired_shard(monkeypatch)
    args = (pd.vals, pd.packed, pd.meta, pd.step_block)
    rng = np.random.default_rng(4)
    x2d = rng.uniform(10.01, 20.42, (plan.x_rows, 128))
    ref = np.asarray(ref_bk.sbell_spmv_tiles(
        *ref_arrays, jnp.asarray(x2d), interpret=True, **kw))
    poison = torch.full((TP, 128), float("nan"), dtype=torch.float64)
    got = bk.sbell_spmv_tiles(*args, torch.from_numpy(x2d), out=poison, **kw)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert np.isfinite(poison.numpy()).all()
    scale = bk.sbell_spmv_tiles_plain(
        pd.vals.abs(), pd.packed, pd.meta, pd.step_block,
        torch.from_numpy(x2d), **kw).numpy()
    npr = 2 * plan.nnz_paired / plan.nrows
    assert allclose_spmv(got.numpy(), ref, np.float64, nnz_per_row=npr,
                         scale=scale)
    # B10 at B = 11 plane by plane against B5; the reference's multi-RHS
    # kernel (slow in the interpreter) on its first two planes
    x3d = rng.uniform(10.01, 20.42, (B, plan.x_rows, 128))
    refm = np.asarray(ref_bk.sbell_spmm_tiles(
        *ref_arrays, jnp.asarray(x3d[:2]), interpret=True, **kw))
    poison = torch.full((B, TP, 128), float("nan"), dtype=torch.float64)
    gotm = bk.sbell_spmm_tiles(*args, torch.from_numpy(x3d), out=poison,
                               **kw)
    assert gotm.dtype == torch.float64 and np.isfinite(poison.numpy()).all()
    for b in range(B):
        assert torch.equal(gotm[b], bk.sbell_spmv_tiles(
            *args, torch.from_numpy(x3d[b]), **kw))
    for b in range(2):
        scale_b = bk.sbell_spmv_tiles_plain(
            pd.vals.abs(), pd.packed, pd.meta, pd.step_block,
            torch.from_numpy(x3d[b]), **kw).numpy()
        assert allclose_spmv(gotm[b].numpy(), refm[b], np.float64,
                             nnz_per_row=npr, scale=scale_b)


def test_sdia_gen_twins_float64_match_reference(monkeypatch):
    """B6 and B12 (B = 11) in float64 on a mirrored float64 shard's
    signed planes, onto nonzero y with the rows past the value blocks
    NaN-poisoned (kept as they are), against the reference's kernels
    (interpret mode); B12 reads X as planes, interleaved and in place."""
    _, port, _ = build("dia_mirrored_p8", monkeypatch)
    sh = port.shards[3].near
    vals, offs = sh.dia_vals, sh.dia_offsets
    assert vals.dtype == torch.float64 and int(offs.min()) < 0
    offsets = tuple(port.dia_offsets)
    rng = np.random.default_rng(5)
    T = sh.num_row_tiles + 3
    body = min(T, vals.shape[0] * 8)
    x2d = rng.uniform(10.01, 20.42, (sh.x_rows, 128))
    y0 = rng.uniform(-1, 1, (T, 128))
    y0[body:] = np.nan
    ref = np.asarray(ref_sk.sdia_gen_tiles(
        jnp.asarray(vals.numpy()), jnp.asarray(x2d), jnp.asarray(y0),
        offsets=offsets, interpret=True))
    y = sk.sdia_gen_tiles(vals, torch.from_numpy(x2d),
                          torch.from_numpy(y0.copy()), offs)
    assert y.dtype == torch.float64 and np.isnan(y.numpy()[body:]).all()
    scale = sk.sdia_gen_tiles_plain(vals.abs(), torch.from_numpy(x2d),
                                    torch.from_numpy(np.abs(y0)), offs)
    D = vals.shape[1]
    assert allclose_spmv(y.numpy()[:body], ref[:body], np.float64,
                         nnz_per_row=D, scale=scale.numpy()[:body])
    X = rng.uniform(10.01, 20.42, (sh.nrows, B))
    x3d = ops.pad_x_mm(torch.from_numpy(X), sh.x_rows)
    Y0 = rng.uniform(-1, 1, (B, T, 128))
    Y0[:, body:] = np.nan
    refm = np.asarray(ref_sk.sdia_gen_tiles_mm(
        jnp.asarray(vals.numpy()), jnp.asarray(x3d.numpy()),
        jnp.asarray(Y0), offsets=offsets, interpret=True))
    scale = sk.sdia_gen_tiles_mm_plain(vals.abs(), x3d,
                                       torch.from_numpy(np.abs(Y0)), offs)
    for x_in, planes in ((x3d, None),
                         (bk.interleave_x(torch.from_numpy(X), sh.x_rows),
                          B),
                         (sk.gen_x(torch.from_numpy(X[:, :8].copy()),
                                   sh.x_rows), 8)):
        Bp = planes or B
        Y = sk.sdia_gen_tiles_mm(vals, x_in, torch.from_numpy(Y0[:Bp].copy()),
                                 offs, planes=planes)
        assert Y.dtype == torch.float64
        assert np.isnan(Y.numpy()[:, body:]).all()
        assert allclose_spmv(Y.numpy()[:, :body], refm[:Bp, :body],
                             np.float64, nnz_per_row=D,
                             scale=scale.numpy()[:Bp, :body])


def test_one_block_trap_absent_rows_float64(monkeypatch):
    """The float64 operator over 8-tile output blocks with an absent row
    range, every stream output allocated poisoned with NaN: y (and Y at B
    = 11) is the unpoisoned result bit for bit, the absent rows read
    exactly 0, and the reference makes the same decisions."""
    csr = _band(4096, 6, 7, holes=(1100, 3000))
    ref = RefDist(csr, ref_mesh(8), comm="gather", dia_min_count=8,
                  dtype=np.float64)
    port = DistSpDMV(port_csr(csr), make_mesh(8, device="cpu"),
                     comm="gather", dia_min_count=8, dtype=np.float64)
    assert decisions(port) == decisions(ref)
    assert port.BT == 8 and port.shard_rows > 8 * 128
    x, X = inputs(csr, 0), inputs(csr, B)
    y0, Y0 = port(x), port(X)
    out_buffer = bk._out_buffer

    def poisoned(out, shape, dev, dtype=torch.float32):
        if out is None:
            return torch.full(shape, float("nan"), dtype=dtype, device=dev)
        return out_buffer(out, shape, dev, dtype)

    monkeypatch.setattr(bk, "_out_buffer", poisoned)
    y, Y = port(x), port(X)
    assert y.dtype == torch.float64
    assert torch.equal(y, y0) and torch.equal(Y, Y0)
    assert torch.equal(y[1100:3000], torch.zeros(1900, dtype=torch.float64))
    assert torch.equal(Y[1100:3000],
                       torch.zeros((1900, B), dtype=torch.float64))
    assert allclose_spmv(y.numpy(), csr.spmv_host(x), np.float64,
                         nnz_per_row=13, scale=csr.spmv_host(x, absolute=True))


def test_float64_cg_over_dist_operator(monkeypatch):
    """CG in float64 over the 4-shard float64 operator solves the paired
    case's shifted system to float64 accuracy."""
    from cfs_spmv_tpu_torch.models import solvers

    _, port, csr = build("paired_p4", monkeypatch)
    n = csr.nrows
    # x -> A x + 60 x is SPD here (|row sums| of A stay under 60)
    shifted = lambda v: port(v) + 60.0 * v  # noqa: E731
    b = np.random.default_rng(0).uniform(1, 2, n)
    x, _, hist = solvers.cg(shifted, torch.from_numpy(b), iters=60)
    assert x.dtype == torch.float64 and hist.shape == (60,)
    res = b - shifted(x).numpy()
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-10


def test_other_dtypes_raise():
    csr = port_csr(MATRICES["uneven"]())
    with pytest.raises(TypeError, match="float32 or float64"):
        DistSpDMV(csr, make_mesh(2, device="cpu"), dtype=np.float16)
