"""The port's plan cache (``cfs_spmv_tpu_torch/io/plancache.py``) on the
CPU: copies of the reference's tests (``tests/test_plancache.py`` and
``test_bfloat16_plan_cache`` of ``tests/test_spmv.py``), the same
``cache_key`` as the reference's, and one cache directory shared by the
two packages in both directions: a plan the reference saved loads in the
port and gives the port's own result; a plan the port saved loads in the
reference as the reference's own build (arrays, dtype tags, scalars).
The float64 plans of the two (native double here, fp32 pairs there)
never share a key, and the port's float64 key names its planner, which
has no row ceiling.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfs_spmv_tpu as ref_cfs
from cfs_spmv_tpu.formats.bell2 import build_general_plan as ref_general
from cfs_spmv_tpu.formats.csr import CSR as RefCSR
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_sbell
from cfs_spmv_tpu.io import plancache as ref_plancache
from cfs_spmv_tpu.tuning import tune as ref_tune
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.formats.bell2 import build_bell2_plan
from cfs_spmv_tpu_torch.formats.coo import COO
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
from cfs_spmv_tpu_torch.io import plancache
from cfs_spmv_tpu_torch.tuning.tune import build_fp64_plan, tune
from cfs_spmv_tpu_torch.utils.config import config
from cfs_spmv_tpu_torch.utils.platform import Format, allclose_spmv

from conftest import random_x

torch.set_num_threads(1)


def port_csr(ref):
    return CSR(ref.nrows, ref.ncols, ref.indptr.copy(), ref.indices.copy(),
               ref.data.copy(), ref.symmetric)


def _plans_equal(a, b, dtypes=False):
    """Field by field; with ``dtypes`` every array's dtype too."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            if dtypes:
                assert va.dtype == vb.dtype, f.name
        elif hasattr(va, "__dataclass_fields__"):
            _plans_equal(va, vb, dtypes)
        else:
            assert va == vb, f.name


@pytest.fixture
def sym_csr(small_sym_coo):
    return port_csr(RefCSR.from_coo(small_sym_coo))


def _y(tuned, x):
    return tuned.matvec(torch.from_numpy(x))


# -- the reference's tests of tests/test_plancache.py, on the port --------

def test_roundtrip_sbell(tmp_path, sym_csr):
    plan = build_sbell_plan(sym_csr, dtype=np.float32, dia_min_count=8)
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    _plans_equal(plan, plancache.load_plan(p), dtypes=True)


def test_roundtrip_bell2(tmp_path):
    coo = COO.random(700, 650, 5.0, bandwidth=200, seed=4)
    plan = build_bell2_plan(CSR.from_coo(coo))
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    _plans_equal(plan, plancache.load_plan(p), dtypes=True)


def test_version_invalidation(tmp_path, sym_csr, monkeypatch):
    plan = build_sbell_plan(sym_csr, dtype=np.float32)
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    monkeypatch.setattr(plancache, "PLAN_VERSION", plancache.PLAN_VERSION + 1)
    with pytest.raises(ValueError):
        plancache.load_plan(p)


def test_cache_key_sensitivity(sym_csr):
    k1 = plancache.cache_key(sym_csr, np.float32, fmt="sbell")
    k2 = plancache.cache_key(sym_csr, np.float64, fmt="sbell")
    k3 = plancache.cache_key(sym_csr, np.float32, fmt="bell2")
    assert len({k1, k2, k3}) == 3
    bumped = CSR(
        sym_csr.nrows, sym_csr.ncols, sym_csr.indptr, sym_csr.indices,
        sym_csr.data * 2, sym_csr.symmetric,
    )
    assert plancache.cache_key(bumped, np.float32, fmt="sbell") != k1


def test_tune_uses_cache(tmp_path, sym_csr):
    d = str(tmp_path / "cache")
    t1 = tune(sym_csr, fmt=Format.SSS, cache_dir=d, device="cpu")
    files = os.listdir(d)
    assert len(files) == 1
    # second tune loads the same plan and computes the same result
    t2 = tune(sym_csr, fmt=Format.SSS, cache_dir=d, device="cpu")
    assert os.listdir(d) == files
    x = random_x(sym_csr.nrows, np.float32)
    y1, y2 = _y(t1, x).numpy(), _y(t2, x).numpy()
    np.testing.assert_array_equal(y1, y2)
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y2, sym_csr.spmv_host(xd), np.float32,
        nnz_per_row=t2.nnz_full / sym_csr.nrows,
        scale=sym_csr.spmv_host(xd, absolute=True),
    )


def test_corrupt_cache_rebuilds(tmp_path, sym_csr):
    d = str(tmp_path / "cache")
    tune(sym_csr, fmt=Format.SSS, cache_dir=d, device="cpu")
    (f,) = os.listdir(d)
    with open(os.path.join(d, f), "wb") as fh:
        fh.write(b"garbage")
    t = tune(sym_csr, fmt=Format.SSS, cache_dir=d, device="cpu")
    x = random_x(sym_csr.nrows, np.float32)
    xd = x.astype(np.float64)
    assert allclose_spmv(
        _y(t, x).numpy(), sym_csr.spmv_host(xd), np.float32,
        nnz_per_row=t.nnz_full / sym_csr.nrows,
        scale=sym_csr.spmv_host(xd, absolute=True),
    )


# -- tests/test_spmv.py::test_bfloat16_plan_cache, on the port ------------

def test_bfloat16_plan_cache(tmp_path):
    coo = COO.random(800, 800, 4.0, symmetric=True, bandwidth=40,
                     seed=22, dtype=np.float64)
    csr = CSR.from_coo(coo)
    d = str(tmp_path)
    t1 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d,
              device="cpu")
    t2 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d,
              device="cpu")
    assert len(os.listdir(d)) == 1
    # bfloat16 values stay bfloat16 through the cache: their bits on the
    # host, torch.bfloat16 on the device
    assert t2.plan.far.vals.dtype == np.uint16
    far = t2.operands.far
    assert (far.vals if far.vals is not None
            else far.entries.vals).dtype == torch.bfloat16
    x = np.random.default_rng(0).uniform(1, 2, csr.nrows).astype(np.float32)
    np.testing.assert_array_equal(_y(t1, x).numpy(), _y(t2, x).numpy())


def test_cache_dir_from_config(tmp_path, sym_csr, monkeypatch):
    """``CFS_PLAN_CACHE`` (``config.plan_cache_dir``) is the default
    ``cache_dir``; ``cache_dir=""`` turns the cache off."""
    d = str(tmp_path / "env")
    monkeypatch.setattr(config, "plan_cache_dir", d)
    tune(sym_csr, fmt=Format.SSS, device="cpu")
    assert len(os.listdir(d)) == 1
    tune(sym_csr, fmt=Format.CSR, cache_dir="", device="cpu")
    assert len(os.listdir(d)) == 1
    monkeypatch.setenv("CFS_PLAN_CACHE", "/some/dir")
    from cfs_spmv_tpu_torch.utils.config import Config

    assert Config().plan_cache_dir == "/some/dir"


# -- one key, one file format, both packages -------------------------------

#: (matrix, format, the build parameters tune() keys each plan by)
KEYED = {
    "sbell": (lambda: ref_proxies.cant_proxy(n=2048), "SSS",
              dict(fmt="sbell", values="same")),
    "sbell_bf16": (lambda: ref_proxies.cant_proxy(n=2048), "SSS",
                   dict(fmt="sbell", values="bfloat16")),
    "bell2": (lambda: ref_proxies.general_asym(g=10), "CSR",
              dict(fmt="bell2", values="same", dia=True)),
    "bell2_bf16": (lambda: ref_proxies.general_asym(g=10), "CSR",
                   dict(fmt="bell2", values="bfloat16", dia=True)),
}


@pytest.mark.parametrize("name", sorted(KEYED))
def test_cache_key_is_the_reference_s(name):
    make, _, params = KEYED[name]
    ref = make()
    for dtype in (np.float32, np.float64):
        assert (plancache.cache_key(port_csr(ref), dtype, **params)
                == ref_plancache.cache_key(ref, dtype, **params))
    assert plancache.PLAN_VERSION == ref_plancache.PLAN_VERSION


def _tune_both(name, d):
    """(port tuned, reference tuned) of KEYED[name] through ``cache_dir``
    ``d`` (the reference first when it should save)."""
    make, fmt, params = KEYED[name]
    ref = make()
    kw = dict(values=params["values"], cache_dir=d)
    return (lambda: tune(port_csr(ref), fmt=getattr(Format, fmt),
                         device="cpu", **kw),
            lambda: ref_tune.tune(ref, fmt=getattr(ref_cfs.Format, fmt),
                                  **kw),
            ref, fmt, params)


@pytest.mark.parametrize("name", sorted(KEYED))
def test_reference_saved_plan_loads_in_the_port(tmp_path, name):
    d = str(tmp_path)
    port, ref_t, ref, _, params = _tune_both(name, d)
    ref_t()  # the reference builds and saves
    files = os.listdir(d)
    assert len(files) == 1
    loaded = port()
    assert os.listdir(d) == files  # a hit, nothing saved
    fresh = tune(port_csr(ref), fmt=loaded.format, values=params["values"],
                 cache_dir="", device="cpu")
    _plans_equal(loaded.plan, fresh.plan, dtypes=True)
    x = random_x(ref.ncols, np.float32)
    assert torch.equal(_y(loaded, x), _y(fresh, x))


@pytest.mark.parametrize("name", sorted(KEYED))
def test_port_saved_plan_loads_in_the_reference(tmp_path, name):
    d = str(tmp_path)
    port, ref_t, ref, fmt, params = _tune_both(name, d)
    port()  # the port builds and saves
    files = os.listdir(d)
    assert len(files) == 1
    loaded = ref_t()
    assert os.listdir(d) == files  # a hit, nothing saved
    if fmt == "SSS":
        own = ref_sbell(ref, dtype=np.float32)
    else:
        own = ref_general(ref, dtype=np.float32, dia=True)
    own = ref_tune._cast_values(own, params["values"])
    _plans_equal(loaded.plan, own, dtypes=True)
    if params["values"] == "bfloat16":
        assert loaded.plan.dia.vals.dtype == jnp.bfloat16


def test_float64_plans_never_share_a_key(tmp_path):
    """The port's float64 plan (IEEE double values) and the reference's
    double-float plan (fp32 hi and lo planes) of one matrix land in two
    files of one directory, and each package loads its own."""
    ref = ref_proxies.cant_proxy(n=2048)
    csr = port_csr(ref)
    d = str(tmp_path)
    assert (plancache.cache_key(csr, np.float64, fmt="bell2_f64")
            != ref_plancache.cache_key(ref, np.float64, fmt="bell2_df"))
    t1 = tune(csr, fmt=Format.SSS, dtype=np.float64, cache_dir=d,
              device="cpu")
    ref_tune._tune_fp64_df(ref, ref_cfs.Format.SSS, cache_dir=d)
    files = sorted(os.listdir(d))
    assert len(files) == 2
    t2 = tune(csr, fmt=Format.SSS, dtype=np.float64, cache_dir=d,
              device="cpu")
    r2 = ref_tune._tune_fp64_df(ref, ref_cfs.Format.SSS, cache_dir=d)
    assert sorted(os.listdir(d)) == files
    assert t2.plan.dia.vals.dtype == np.float64 and t2.plan.vals2 is None
    assert r2.plan.dia is None or r2.plan.dia.vals.dtype == np.float64
    x = random_x(csr.ncols, np.float64)
    y = t2.matvec(torch.from_numpy(x))
    assert torch.equal(y, t1.matvec(torch.from_numpy(x)))
    assert allclose_spmv(y.numpy(), csr.spmv_host(x), np.float64,
                         nnz_per_row=t2.nnz_full / csr.nrows,
                         scale=csr.spmv_host(x, absolute=True))


def test_float64_key_is_not_the_ceiling_planner_s(tmp_path):
    """The float64 planner without a row ceiling keys its plans apart from
    the one before it (``fmt="bell2_f64"`` alone), which expanded every
    matrix past 5M rows: a plan saved under the old key is not loaded."""
    csr = port_csr(ref_proxies.stencil27(g=12, dtype=np.float64))
    old_key = plancache.cache_key(csr, np.float64, fmt="bell2_f64")
    d = str(tmp_path)
    old_path = os.path.join(d, f"plan-{old_key}.npz")
    # the old planner's plan past its ceiling: both triangles, no peel
    expanded = build_fp64_plan(CSR.from_coo(csr.to_coo().expand_symmetric()))
    assert expanded.dia is None
    plancache.save_plan(old_path, expanded)
    tuned = tune(csr, fmt=Format.SSS, dtype=np.float64, cache_dir=d,
                 device="cpu")
    assert tuned.plan.dia is not None and tuned.plan.nnz == 0
    files = sorted(os.listdir(d))
    assert len(files) == 2 and os.path.basename(old_path) in files
    again = tune(csr, fmt=Format.SSS, dtype=np.float64, cache_dir=d,
                 device="cpu")
    assert sorted(os.listdir(d)) == files  # its own key: a hit
    _plans_equal(again.plan, tuned.plan, dtypes=True)
