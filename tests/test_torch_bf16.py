"""bfloat16 value storage (``values="bfloat16"``) in the port, on the CPU,
against the reference (Pallas in interpret mode) and the float64 oracle.

- The bits: every value tensor the port uploads in bfloat16 (the paired
  and one-sided chunk grids, the diagonal planes, an entry list's values)
  holds exactly the bits of the reference's ``_cast_values`` (round to
  nearest even), on symmetric plans with diagonals, a far stream (as
  entries and as a grouped grid) and a paired stream, and on peeled
  general plans.
- End to end: ``SpDMV`` and ``SpDMM`` (B = 11) against the reference's
  bf16 ``tune(...).matvec`` / ``matmat`` at float32's ``allclose_spmv``
  (both sum the same bf16 values in float32), and against the oracle at
  a 2-byte type's 5e-2.
- The one-block trap: replans over 8-tile blocks with absent rows, through
  each bf16 wrapper into NaN-poisoned outputs, bit for bit the float32
  twin on the widened values.
- ``stream_bytes()`` is the reference's and under float32's; the tuned
  matrix's dtype stays float32; float64 ignores ``values`` as the
  reference's route does; a bf16 ``SpDMV`` after a float32 one retunes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import cfs_spmv_tpu as ref_cfs
import cfs_spmv_tpu_torch as ct
from cfs_spmv_tpu.formats import sdia as ref_sdia
from cfs_spmv_tpu.formats.bell2 import build_bell2_plan as ref_bell2_plan
from cfs_spmv_tpu.formats.bell2 import build_general_plan as ref_general
from cfs_spmv_tpu.formats.coo import COO as RefCOO
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_sbell
from cfs_spmv_tpu.ops import spmv as ref_ops
from cfs_spmv_tpu.tuning import tune as ref_tune
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.formats import sdia as port_sdia
from cfs_spmv_tpu_torch.formats.bell2 import (build_bell2_plan,
                                              build_general_plan)
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.ops import bell2_kernel as bk
from cfs_spmv_tpu_torch.ops import sdia_kernel as sk
from cfs_spmv_tpu_torch.ops import spmv as ops
from cfs_spmv_tpu_torch.tuning import tune as port_tune
from cfs_spmv_tpu_torch.utils.platform import allclose_spmv

from conftest import random_x

torch.set_num_threads(1)

BF16 = "bfloat16"


def port_csr(ref):
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


def _shuffled_band():
    from test_torch_spmv import shuffled_band

    return shuffled_band()


#: name -> (reference CSR, format, CFS_PAIRED, mirrored diagonals,
#: reorder); every float32 branch that takes bf16 values
CASES = {
    "sdia_cant": (lambda: ref_proxies.cant_proxy(n=4096), "SSS", None,
                  False, "auto"),
    "sdia_far_entries": (__graft_entry__._flagship, "SSS", None, False,
                         "auto"),
    "grouped_far": (lambda: ref_proxies.audikw_proxy(nb=1000), "SSS", None,
                    False, False),
    "paired_far": (lambda: ref_proxies.near_band_paired(
        n=4000, n_diags=32, max_off=300, seed=5), "SSS", "force", False,
        "auto"),
    "mirrored": (lambda: ref_proxies.cant_proxy(n=4096), "SSS", None, True,
                 "auto"),
    "general_peel": (lambda: ref_proxies.general_asym(g=12), "CSR", None,
                     False, "auto"),
    "general_peel_residual": (__graft_entry__._flagship, "CSR", None, False,
                              "auto"),
    "rcm": (_shuffled_band, "SSS", None, False, "auto"),
}


def _setup(name, monkeypatch):
    gen, fmt, paired, mirrored, reorder = CASES[name]
    if paired:
        monkeypatch.setenv("CFS_PAIRED", paired)
    if mirrored:
        monkeypatch.setattr(ref_sdia, "SDIA_SYM_ROWS_MAX", 100)
        monkeypatch.setattr(port_sdia, "SDIA_SYM_ROWS_MAX", 100)
    return gen(), fmt, reorder


def _ref_bits(a):
    """The reference's cast of a float32 array, as uint16 bits."""
    return np.asarray(a).astype(jnp.bfloat16).view(np.uint16)


def _dev(tuned):
    d = tuned.operands
    return d["dev"] if isinstance(d, dict) else d


def _uploaded(d):
    """{name: bf16 tensor} of every value tensor an upload holds."""
    out = {}
    for pre, s in (("", d), ("far.", getattr(d, "far", None))):
        if s is None:
            continue
        for k in ("vals", "dia_vals"):
            if getattr(s, k, None) is not None:
                out[pre + k] = getattr(s, k)
        if getattr(s, "entries", None) is not None:
            out[pre + "entries.vals"] = s.entries.vals
    return out


@pytest.mark.parametrize("name", ["sdia_far_entries", "grouped_far",
                                  "paired_far", "mirrored", "general_peel",
                                  "general_peel_residual"])
def test_uploaded_bits_are_the_reference_cast(name, monkeypatch):
    ref_csr, fmt, reorder = _setup(name, monkeypatch)
    general = fmt == "CSR"
    if general:
        src = (RefCSR.from_coo(ref_csr.to_coo().expand_symmetric())
               if ref_csr.symmetric else ref_csr)
        ref_plan = ref_tune._cast_values(ref_general(src, dia=True), BF16)
        plan = port_tune._cast_values(
            build_general_plan(port_csr(src), dia=True), BF16)
        d = ops.to_device(plan, "cpu")
    else:
        ref_plan = ref_tune._cast_values(ref_sbell(ref_csr), BF16)
        plan = port_tune._cast_values(build_sbell_plan(port_csr(ref_csr)),
                                      BF16)
        d = ops.sym_to_device(plan, "cpu")
    # the host plan holds the reference's bits
    pairs = [("vals", plan.vals, ref_plan.vals)]
    for part in ("far", "dia"):
        if getattr(plan, part, None) is not None:
            pairs.append((part, getattr(plan, part).vals,
                          getattr(ref_plan, part).vals))
    for what, mine, theirs in pairs:
        assert mine.dtype == np.uint16, what
        np.testing.assert_array_equal(mine, theirs.view(np.uint16),
                                      err_msg=what)
    up = _uploaded(d)
    assert up and all(t.dtype == torch.bfloat16 for t in up.values())
    far = getattr(ref_plan, "far", None)
    for k, t in up.items():
        bits = t.view(torch.int16).numpy().view(np.uint16)
        if k.endswith("entries.vals"):
            # the entry list of the cast grid: its live slots, row-sorted
            grid = far if k.startswith("far.") else ref_plan
            es = bk.compact_stream(
                np.asarray(grid.vals, np.float32), grid.packed, grid.meta,
                grid.step_block, chunks_per_step=grid.chunks_per_step,
                tiles_per_block=grid.tiles_per_block,
                contig=grid.windows_contig or grid.window_depth > 8,
                num_row_tiles=grid.num_row_tiles, x_rows=grid.x_rows)
            np.testing.assert_array_equal(bits, _ref_bits(es.vals.numpy()))
            continue
        src = {"vals": ref_plan.vals, "far.vals": getattr(far, "vals", None),
               "dia_vals": getattr(ref_plan.dia, "vals", None)}[k]
        np.testing.assert_array_equal(
            bits, np.asarray(src).view(np.uint16).reshape(bits.shape),
            err_msg=k)
    if name == "sdia_far_entries":
        assert {"dia_vals", "far.entries.vals"} <= set(up)
    if name == "grouped_far":
        assert "far.vals" in up and d.far.grouped
    if name == "paired_far":
        assert d.has_paired and "vals" in up


def _tolerance_checks(y, y_ref, csr, x, nnz_full):
    """Against the reference's bf16 result at float32's gate, and against
    the float64 oracle at a 2-byte type's."""
    xd = x.astype(np.float64)
    scale = csr.spmv_host(xd, absolute=True)
    kw = dict(nnz_per_row=nnz_full / csr.nrows, scale=scale)
    assert allclose_spmv(y, y_ref, np.float32, **kw)
    assert allclose_spmv(y, csr.spmv_host(xd), np.float16, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spdmv_bf16_matches_reference_and_oracle(name, monkeypatch):
    ref_csr, fmt, reorder = _setup(name, monkeypatch)
    csr = port_csr(ref_csr)
    x = random_x(csr.ncols, np.float32)
    A = ct.SparseMatrix.create(csr, getattr(ct.Format, fmt))
    y = ct.SpDMV(A, values=BF16, reorder=reorder, device="cpu")(x)
    assert y.dtype == torch.float32 and A.tuned.dtype == torch.float32
    R = ref_tune.tune(ref_csr, fmt=getattr(ref_cfs.Format, fmt),
                      values=BF16, reorder=reorder)
    y_ref = np.asarray(R.matvec(x))
    _tolerance_checks(y.numpy(), y_ref, csr, x, A.tuned.nnz_full)
    assert A.tuned.nnz_full == R.nnz_full
    assert (A.tuned.perm is not None) == (name == "rcm")
    assert A.tuned.stream_bytes() == R.stream_bytes()
    # a float64 tensor x is cast to the tuned matrix's float32, not
    # retuned for
    tuned = A.tuned
    assert torch.equal(ct.SpDMV(A, values=BF16, reorder=reorder,
                                device="cpu")(torch.from_numpy(
                                    x.astype(np.float64))), y)
    assert A.tuned is tuned
    assert all(t.dtype == torch.bfloat16
               for t in _uploaded(_dev(A.tuned)).values())


@pytest.mark.parametrize("name", ["sdia_far_entries", "grouped_far",
                                  "paired_far", "general_peel_residual"])
def test_spdmm_bf16_matches_reference_and_oracle(name, monkeypatch):
    """B = 11: two plane groups of the multi-RHS wrappers."""
    ref_csr, fmt, reorder = _setup(name, monkeypatch)
    csr = port_csr(ref_csr)
    X = np.random.default_rng(8).uniform(10.01, 20.42, (csr.ncols, 11))
    X = X.astype(np.float32)
    A = ct.SparseMatrix.create(csr, getattr(ct.Format, fmt))
    Y = ct.SpDMM(A, values=BF16, reorder=reorder, device="cpu")(X).numpy()
    assert torch.equal(A @ torch.from_numpy(X), torch.from_numpy(Y))
    R = ref_tune.tune(ref_csr, fmt=getattr(ref_cfs.Format, fmt),
                      values=BF16, reorder=reorder)
    Y_ref = np.asarray(R.matmat(X))
    assert Y.shape == Y_ref.shape == (csr.nrows, 11)
    d = _dev(A.tuned)
    assert {"grouped_far": lambda: d.far.grouped,
            "paired_far": lambda: d.has_paired and d.far.entries is not None,
            "sdia_far_entries": lambda: d.far.entries is not None,
            "general_peel_residual": lambda: d.entries is not None}[name]()
    for b in range(11):
        _tolerance_checks(Y[:, b], Y_ref[:, b], csr, X[:, b],
                          A.tuned.nnz_full)


def _holes_csr():
    coo = ref_proxies.random_band(n=4000, per_row=10, half_bw=1000).to_coo()
    keep = (coo.row < 1024) | (coo.row >= 3072)
    return RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                  coo.col[keep], coo.val[keep]))


def _paired_holes_csr():
    coo = ref_proxies.near_band_paired(n=4000, n_diags=32, max_off=300,
                                       seed=5).to_coo()
    keep = (((coo.row < 1100) | (coo.row >= 3000))
            & ((coo.col < 1100) | (coo.col >= 3000)))
    return RefCSR.from_coo(RefCOO(coo.nrows, coo.ncols, coo.row[keep],
                                  coo.col[keep], coo.val[keep],
                                  symmetric=True))


def _widened(d):
    """The upload ``d`` with every bf16 value tensor widened to float32."""
    import dataclasses

    ch = {}
    for k in ("vals", "dia_vals"):
        t = getattr(d, k, None)
        if t is not None and t.dtype == torch.bfloat16:
            ch[k] = t.float()
    if getattr(d, "entries", None) is not None:
        ch["entries"] = dataclasses.replace(d.entries,
                                            vals=d.entries.vals.float())
    return dataclasses.replace(d, **ch)


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["grid_holes", "entries_holes",
                                  "paired_holes", "dia_store"])
def test_bf16_wrappers_on_replans_with_absent_rows(name, monkeypatch):
    """Replans over 8-tile blocks whose middle rows are absent: each bf16
    wrapper, SpMV and at B = 11, writes or adds into NaN-poisoned planes
    exactly what its float32 twin does on the widened values (unvisited
    blocks keep their NaN, rows no entry names keep theirs, a zeroed
    output's absent rows read exactly 0), and the applier agrees with the
    reference's on the same bf16 plan."""
    if name == "grid_holes":
        ref = ref_bell2_plan(_holes_csr(), tiles_per_block=8)
    elif name == "entries_holes":
        ref = ref_bell2_plan(_holes_csr(), tiles_per_block=8,
                             cover_all_tiles=False)
    elif name == "paired_holes":
        monkeypatch.setenv("CFS_PAIRED", "force")
        ref = ref_sbell(_paired_holes_csr(), tiles_per_block=8)
    else:
        ref = ref_general(ref_proxies.general_asym(g=12), dia=True)
    ref = ref_tune._cast_values(ref, BF16)
    port = build_port_plan(name, monkeypatch)
    port = port_tune._cast_values(port, BF16)
    sym = name == "paired_holes"
    d = (ops.sym_to_device if sym else ops.to_device)(port, "cpu")
    w = _widened(d)
    rng = np.random.default_rng(5)
    n = port.nrows if sym else port.ncols
    x = torch.from_numpy(rng.uniform(1, 2, n).astype(np.float32))
    B = 11
    X = torch.from_numpy(rng.uniform(1, 2, (n, B)).astype(np.float32))
    x2d = ops.pad_x(x, d.x_rows)
    x3d = ops.pad_x_mm(X, d.x_rows)
    nan = float("nan")
    if name == "grid_holes":
        assert d.tiles_per_block == 8 and d.covers  # zeroed whole
        TP = -(-d.num_row_tiles // 8) * 8
        kw = d.stream_kw()
        got = bk.bell2_spmv_tiles(d.vals, d.packed, d.meta, d.step_block, x2d,
                                  out=torch.full((TP, 128), nan), **kw)
        want = bk.bell2_spmv_tiles(w.vals, w.packed, w.meta, w.step_block,
                                   x2d, out=torch.full((TP, 128), nan), **kw)
        _same(got, want)
        absent = got.reshape(-1)[1024:3072]  # rows no entry names
        assert torch.equal(absent, torch.zeros_like(absent))
        x_il = bk.interleave_x(X, d.x_rows)
        got = bk.bell2_spmm_tiles(d.vals, d.packed, d.meta, d.step_block,
                                  x_il, planes=B,
                                  out=torch.full((B, TP, 128), nan), **kw)
        want = bk.bell2_spmm_tiles(w.vals, w.packed, w.meta, w.step_block,
                                   x_il, planes=B,
                                   out=torch.full((B, TP, 128), nan), **kw)
        _same(got, want)
    elif name == "entries_holes":
        assert d.entries is not None and d.entries.vals.dtype == torch.bfloat16
        y0 = torch.full((d.num_row_tiles, 128), nan)
        got = bk.bell2_spmv_tiles_accum(d.entries, x2d, y0.clone())
        want = bk.bell2_spmv_tiles_accum(w.entries, x2d, y0.clone())
        _same(got, want)
        Y0 = torch.full((B, d.num_row_tiles, 128), nan)
        _same(bk.bell2_spmm_tiles_accum(d.entries, x3d, Y0.clone()),
              bk.bell2_spmm_tiles_accum(w.entries, x3d, Y0.clone()))
    elif name == "paired_holes":
        assert d.has_paired and d.tiles_per_block == 8
        TP = -(-d.num_row_tiles // 8) * 8
        kw = dict(num_row_tiles=d.num_row_tiles,
                  chunks_per_step=d.chunks_per_step, tiles_per_block=8,
                  transpose_windows=d.transpose_windows)
        got = bk.sbell_spmv_tiles(d.vals, d.packed, d.meta, d.step_block, x2d,
                                  out=torch.full((TP, 128), nan), **kw)
        want = bk.sbell_spmv_tiles(w.vals, w.packed, w.meta, w.step_block,
                                   x2d, **kw)
        _same(got, want)
        absent = got.reshape(-1)[1100:3000]
        assert torch.equal(absent, torch.zeros_like(absent))
        got = bk.sbell_spmm_tiles(d.vals, d.packed, d.meta, d.step_block, x3d,
                                  out=torch.full((B, TP, 128), nan), **kw)
        _same(got, bk.sbell_spmm_tiles(w.vals, w.packed, w.meta,
                                       w.step_block, x3d, **kw))
    else:
        assert d.dia_vals.dtype == torch.bfloat16 and not d.has_work
        T = -(-d.nrows // 128) + 2  # rows past the value blocks
        got = sk.sdia_gen_tiles(d.dia_vals, x, torch.full((T, 128), nan),
                                d.dia_offsets, store=True)
        _same(got, sk.sdia_gen_tiles(w.dia_vals, x, torch.zeros((T, 128)),
                                     d.dia_offsets))
        assert torch.isfinite(got).all()
        Yg = torch.full((B, T, 128), nan)
        got = sk.sdia_gen_tiles_mm(d.dia_vals, sk.gen_x(X, d.x_rows), Yg,
                                   d.dia_offsets, planes=B, store=True)
        _same(got, sk.sdia_gen_tiles_mm(w.dia_vals, x3d,
                                        torch.zeros((B, T, 128)),
                                        d.dia_offsets))
    # the applier on the same bf16 plan, against the reference's
    if sym:
        y = ops.sbell_apply(d, x)
        y_ref = np.asarray(ref_ops.sbell_apply(ref_ops.sym_to_device(ref),
                                               x.numpy()))
    else:
        y = ops.bell2_apply(d, x)
        y_ref = np.asarray(ref_ops.bell2_apply(ref_ops.to_device(ref),
                                               x.numpy()))
    scale = np.abs(y_ref).max()
    assert np.abs(y.numpy() - y_ref).max() <= 1e-5 * scale


def build_port_plan(name, monkeypatch):
    if name == "grid_holes":
        return build_bell2_plan(port_csr(_holes_csr()), tiles_per_block=8)
    if name == "entries_holes":
        return build_bell2_plan(port_csr(_holes_csr()), tiles_per_block=8,
                                cover_all_tiles=False)
    if name == "paired_holes":
        return build_sbell_plan(port_csr(_paired_holes_csr()),
                                tiles_per_block=8)
    return build_general_plan(port_csr(ref_proxies.general_asym(g=12)),
                              dia=True)


def test_stream_bytes_and_dtype():
    """bf16 halves the value bytes: the reference's count, under
    float32's; x, y and the tuned matrix stay float32."""
    ref_csr = ref_proxies.cant_proxy(n=4096)
    csr = port_csr(ref_csr)
    t32 = port_tune.tune(csr, fmt=ct.Format.SSS, device="cpu")
    tbf = port_tune.tune(csr, fmt=ct.Format.SSS, values=BF16, device="cpu")
    ref_bf = ref_tune.tune(ref_csr, fmt=ref_cfs.Format.SSS, values=BF16)
    assert tbf.stream_bytes() == ref_bf.stream_bytes() < t32.stream_bytes()
    dia = tbf.plan.dia.vals
    assert t32.stream_bytes() - tbf.stream_bytes() == 2 * dia.size
    assert tbf.dtype == t32.dtype == torch.float32
    assert tbf.operands.diag.dtype == torch.float32
    y = tbf.matvec(torch.ones(csr.ncols))
    assert y.dtype == torch.float32


def test_float64_ignores_bf16_values():
    """The reference's float64 route returns before the cast: the port's
    float64 plan with ``values="bfloat16"`` is the one without, in
    float64, and so is its result."""
    csr = port_csr(__graft_entry__._flagship())
    x = random_x(csr.ncols, np.float64)
    A = ct.SparseMatrix.create(csr, ct.Format.SSS)
    y = ct.SpDMV(A, dtype=np.float64, values=BF16, device="cpu")(x)
    assert y.dtype == torch.float64 and A.tuned.dtype == torch.float64
    assert A.tuned.plan.vals.dtype == np.float64
    y_same = port_tune.tune(csr, fmt=ct.Format.SSS, dtype=np.float64,
                            device="cpu").matvec(torch.from_numpy(x))
    assert torch.equal(y, y_same)
    assert allclose_spmv(y.numpy(), csr.spmv_host(x), np.float64,
                         nnz_per_row=A.tuned.nnz_full / csr.nrows,
                         scale=csr.spmv_host(x, absolute=True))
    with pytest.raises(ValueError, match="values"):
        port_tune.tune(csr, dtype=np.float64, values="float16",
                       device="cpu")


def test_spdmv_retunes_for_bf16_after_float32(small_sym_coo):
    """A bf16 ``SpDMV`` after a float32 one on the same matrix retunes
    (``tune_signature`` holds ``values``), and back again."""
    coo = small_sym_coo
    A = ct.SparseMatrix.create(port_csr(RefCSR.from_coo(coo)),
                               ct.Format.SSS)
    x = random_x(A.ncols, np.float32)
    y32 = ct.SpDMV(A, device="cpu")(x)
    plan32 = A.tuned
    ybf = ct.SpDMV(A, values=BF16, device="cpu")(x)
    assert A.tuned is not plan32
    assert A.tuned.plan.stream_bytes() < plan32.plan.stream_bytes()
    assert not torch.equal(y32, ybf)
    ct.SpDMV(A, device="cpu")(x)
    assert A.tuned.stream_bytes() == plan32.stream_bytes()
    with pytest.raises(ValueError, match="values"):
        ct.SpDMV(A, values="half", device="cpu")
