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
from cfs_spmv_tpu.formats.sbell import build_sbell_plan as ref_build
from cfs_spmv_tpu.utils import proxies as ref_proxies
from cfs_spmv_tpu_torch.formats.csr import CSR
from cfs_spmv_tpu_torch.formats.sbell import build_sbell_plan
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


def test_smoke_flagship_matches_reference_generator():
    """``chip_smoke.flagship`` (written against the port's COO/CSR) is the
    reference's ``__graft_entry__._flagship``."""
    for kw in ({}, dict(n=2048, deg=32, seed=3)):
        assert_same_plan(chip_smoke.flagship(**kw),
                         port_csr(__graft_entry__._flagship(**kw)), "csr")
