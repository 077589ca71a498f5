"""The plain reference against a dense NumPy product at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from spmv_bench import matrices, reference
from spmv_bench.generators import hpcg27

from .conftest import dense


@pytest.fixture(params=[(4, 3, 5), (7, 2, 3), (1, 1, 9)])
def mat(request):
    nx, ny, nz = request.param
    return matrices.Matrix(*hpcg27.make({"nx": nx, "ny": ny, "nz": nz}))


def test_matvec_and_abs_against_dense(mat):
    ref = reference.Reference(mat, "cpu")
    a = dense(mat)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, mat.n)
    y = ref.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, a @ x, rtol=1e-12, atol=1e-12)
    s = ref.matvec(torch.as_tensor(x), absolute=True).numpy()
    np.testing.assert_allclose(s, np.abs(a) @ np.abs(x), rtol=1e-12)
    xx = rng.uniform(-1, 1, (mat.n, 3))
    yy = ref.matvec(torch.as_tensor(xx)).numpy()
    np.testing.assert_allclose(yy, a @ xx, rtol=1e-12, atol=1e-12)


def test_cg_against_a_dense_cg():
    mat = matrices.Matrix(*hpcg27.make({"nx": 4, "ny": 4, "nz": 4}))
    a = dense(mat)
    b = np.random.default_rng(2).uniform(-1, 1, mat.n)
    x, r, p = np.zeros(mat.n), b.copy(), b.copy()
    rs = r @ r
    for _ in range(7):
        ap = a @ p
        alpha = rs / (p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        rs, rs_old = r @ r, rs
        p = r + rs / rs_old * p
    got = reference.Reference(mat, "cpu").cg(torch.as_tensor(b), 7).numpy()
    np.testing.assert_allclose(got, x, rtol=1e-11, atol=1e-13)
    # and enough iterations solve it
    full = reference.Reference(mat, "cpu").cg(torch.as_tensor(b), 64)
    np.testing.assert_allclose(a @ full.numpy(), b, atol=1e-9)


def test_errors_read_nan_and_infinity_as_infinite():
    y_ref = torch.ones(4, dtype=torch.float64)
    scale = torch.full((4,), 2.0, dtype=torch.float64)
    y = torch.tensor([1.0, 1.0, 1.5, 1.0])
    assert reference.apply_error(y, y_ref, scale) == pytest.approx(0.25)
    y[1] = float("nan")
    assert reference.apply_error(y, y_ref, scale) == math.inf
    x = torch.tensor([3.0, 4.0])
    assert reference.solve_error(x, torch.tensor([3.0, 4.0],
                                                 dtype=torch.float64)) == 0
    assert reference.solve_error(torch.tensor([math.inf, 0.0]),
                                 torch.tensor([1.0, 0.0],
                                              dtype=torch.float64)) == math.inf
