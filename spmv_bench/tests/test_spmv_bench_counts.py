"""The canonical byte and operation counts against hand counts."""

import numpy as np
import pytest

from spmv_bench import counts, matrices
from spmv_bench.generators import hpcg27


def _mat(g):
    return matrices.Matrix(*hpcg27.make({"nx": g, "ny": g, "nz": g}))


def test_counts_of_a_2x2x2_grid_by_hand():
    # every point of a 2x2x2 grid touches all 8: 64 nonzeros, 36 stored
    mat = _mat(2)
    assert (mat.n, mat.logical_nnz, mat.stored_nnz) == (8, 64, 36)
    # 36 values x 8 B, x and y 8 x 8 B each
    assert counts.apply_bytes(mat.n, mat.stored_nnz, 1, "float64") == 416
    assert counts.value_bytes(mat.stored_nnz, "float64") == 288
    # B = 8 in float32: 36 x 4 + 2 x 8 x 8 x 4
    assert counts.apply_bytes(mat.n, mat.stored_nnz, 8, "float32") == 656
    assert counts.apply_flops(mat.logical_nnz, 1) == 128
    assert counts.apply_flops(mat.logical_nnz, 8) == 1024


def test_counts_of_a_3x3x3_grid_by_hand():
    # 27 points; corners touch 8, edges 12, faces 18, the centre 27
    mat = _mat(3)
    assert mat.logical_nnz == 8 * 8 + 12 * 12 + 6 * 18 + 27 == 7**3
    assert mat.stored_nnz == (343 + 27) // 2
    assert counts.apply_bytes(27, 185, 1, "float64") == 185 * 8 + 2 * 27 * 8


def test_the_full_size_cells_counts():
    # hpcg-256: 766^3 logical, (766^3 + 256^3) / 2 stored
    stored = (766**3 + 256**3) // 2
    assert stored == 233_116_156
    nbytes = counts.apply_bytes(256**3, stored, 1, "float64")
    assert nbytes == 1_864_929_248 + 268_435_456
    peak = counts.peak_for("NVIDIA H100 80GB HBM3")
    bound = counts.bound_s(nbytes, counts.apply_flops(766**3, 1), peak,
                           "float64")
    assert bound == pytest.approx(6.368e-4, rel=1e-3)  # bytes bound it
    # B = 8: the values once, X and Y of 8 columns each
    nbytes8 = counts.apply_bytes(256**3, stored, 8, "float64")
    assert nbytes8 == 1_864_929_248 + 8 * 268_435_456


def test_an_unknown_card_has_no_peaks():
    with pytest.raises(ValueError, match="no peaks"):
        counts.peak_for("cpu")


def test_operations_never_bound_an_apply():
    # 2 operations a nonzero against at least 4 bytes: bytes bound both
    peak = counts.peak_for("NVIDIA H100 80GB HBM3")
    for prec, rate in (("float32", peak.fp32_flops),
                       ("float64", peak.fp64_flops)):
        per_nnz_s = np.dtype(prec).itemsize / peak.hbm_bytes_s
        assert 2 / rate < per_nnz_s / 10
