"""Shared pieces of the benchmark's tests (``python -m pytest
spmv_bench/tests -q`` from the root; on the card the ``card`` tests run
too). Nothing here imports JAX."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def bench():
    """BENCHMARK.json as the repository holds it."""
    from spmv_bench import spec

    return spec.load_benchmark()


#: CPU sizes of each configuration: a few thousand rows
SMALL = {"hpcg-256": {"nx": 12, "ny": 11, "nz": 10}}


def small_config(bench, cell_name):
    """The configuration of ``cell_name`` at its CPU test size."""
    from spmv_bench import spec

    cfg = spec.config(bench, spec.cell(bench, cell_name)["config"])
    return {**cfg, **SMALL[cfg["name"]]}


def dense(mat):
    """The full symmetric matrix of a lower-triangle ``matrices.Matrix``."""
    import numpy as np

    a = np.zeros((mat.n, mat.n))
    rows = np.repeat(np.arange(mat.n), np.diff(mat.indptr))
    a[rows, mat.indices] = mat.data
    return a + np.tril(a, -1).T


def result_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
