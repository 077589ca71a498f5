"""The configuration's generator, HPCG's stencil, the traffic's inputs and
the CG traffic's right-hand sides."""

import numpy as np
import pytest
import torch

from cfs_spmv_tpu_torch.utils.proxies import stencil27
from spmv_bench import harness, matrices, spec
from spmv_bench.generators import hpcg27

from .conftest import dense, small_config


@pytest.mark.parametrize("g", [2, 3, 5, 8])
def test_hpcg_nonzeros_are_3g_minus_2_cubed(g):
    mat = matrices.Matrix(*hpcg27.make({"nx": g, "ny": g, "nz": g}))
    assert mat.logical_nnz == (3 * g - 2) ** 3
    assert mat.stored_nnz == ((3 * g - 2) ** 3 + g**3) // 2


def test_hpcg_values_and_pattern():
    nx, ny, nz = 5, 4, 3
    mat = matrices.Matrix(*hpcg27.make({"nx": nx, "ny": ny, "nz": nz}))
    a = dense(mat)
    assert mat.data.dtype == np.float64
    assert np.all(np.diag(a) == 26.0)
    # the stencil by its definition: -1 between distinct points of one box
    idx = np.arange(nx * ny * nz)
    x, y, z = idx % nx, idx // nx % ny, idx // (nx * ny)
    near = ((np.abs(x[:, None] - x) <= 1) & (np.abs(y[:, None] - y) <= 1)
            & (np.abs(z[:, None] - z) <= 1))
    want = np.where(near, -1.0, 0.0)
    np.fill_diagonal(want, 26.0)
    np.testing.assert_array_equal(a, want)
    # columns ascend within each row, all in the lower triangle
    for r in range(mat.n):
        cols = mat.indices[mat.indptr[r]:mat.indptr[r + 1]]
        assert np.all(np.diff(cols) > 0) and cols[-1] == r


def test_hpcg_pattern_matches_the_ports_stencil27():
    # the same 27-point pattern as the port's stencil27 (values differ)
    mat = matrices.Matrix(*hpcg27.make({"nx": 6, "ny": 6, "nz": 6}))
    ref = stencil27(g=6)
    np.testing.assert_array_equal(mat.indptr, ref.indptr)
    np.testing.assert_array_equal(mat.indices, ref.indices)


def test_cg_traffic_b_is_a_x_true(bench):
    cfg = small_config(bench, "hpcg256-cg")
    mat = matrices.make(cfg)
    mix = spec.mix("cg50")
    t = harness.Traffic(mix, mat, cfg, 2**31 + 5, "cpu")
    g = torch.Generator(device="cpu")
    g.manual_seed(2**31 + 5)
    a = dense(mat)
    for b in t.inputs:
        x_true = torch.rand(mat.n, generator=g, dtype=torch.float64) * 2 - 1
        np.testing.assert_allclose(b.numpy(), a @ x_true.numpy(),
                                   rtol=1e-13, atol=1e-12)
    assert len(t.inputs) == mix["pool"]


def test_traffic_repeats_for_a_seed_and_differs_across_seeds(bench):
    cfg = small_config(bench, "hpcg256-spmv")
    mat = matrices.make(cfg)
    mix = spec.mix("spmm8")
    a = harness.Traffic(mix, mat, cfg, 7, "cpu")
    b = harness.Traffic(mix, mat, cfg, 7, "cpu")
    c = harness.Traffic(mix, mat, cfg, 8, "cpu")
    assert a.inputs[0].shape == (mat.n, 8)
    assert all(torch.equal(x, y) for x, y in zip(a.inputs, b.inputs))
    assert not torch.equal(a.inputs[0], c.inputs[0])
