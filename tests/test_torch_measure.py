"""The port's measurement layer on the CPU: ``utils/roofline.py``,
``utils/timing.py``, ``utils/trace.py`` and the benchmark CLI
``cli/bench_spmv_mmf.py`` (copies of the ``bench_spmv_mmf`` cases of
``tests/test_cli.py`` with ``--device cpu``).

The roofline arithmetic is the reference's, number for number; the card
names map to the H100 parts, found by monkeypatching what PyTorch reports
(this host has no card). Times here are the CPU's: the tests check that
they are positive seconds, not what they are.
"""

import numpy as np
import pytest
import torch

from cfs_spmv_tpu.utils import roofline as ref_roofline
from cfs_spmv_tpu_torch import COO, CSR, Format, SparseMatrix, SpDMV
from cfs_spmv_tpu_torch.cli.bench_spmv_mmf import main as run_bench_cli
from cfs_spmv_tpu_torch.io.mmf import write_mmf
from cfs_spmv_tpu_torch.tuning.tune import tune
from cfs_spmv_tpu_torch.utils import roofline, timing
from cfs_spmv_tpu_torch.utils.trace import profile, report_spmv

torch.set_num_threads(1)


@pytest.mark.parametrize("value_bytes,vector_bytes,passes", [
    (4, 4, 1), (8, 8, 1), (2, 4, 2), (4, 8, 3)])
@pytest.mark.parametrize("nnz,nrows,ncols", [
    (5_000, 700, 700), (1, 1, 1), (0, 10, 12), (78_500_000, 1_000_000,
                                                 900_000)])
def test_roofline_arithmetic_is_the_reference_s(value_bytes, vector_bytes,
                                                passes, nnz, nrows, ncols):
    kw = dict(value_bytes=value_bytes, index_bytes=4, nnz=nnz, nrows=nrows,
              ncols=ncols, vector_bytes=vector_bytes, passes=passes)
    bpn = roofline.spmv_bytes_per_nnz(**kw)
    assert bpn == ref_roofline.spmv_bytes_per_nnz(**kw)
    chip = roofline.detect_chip()
    ref_chip = ref_roofline.ChipSpec("same", chip.hbm_bw_bytes_s, 0, 0, 0)
    assert (roofline.speed_of_light_nnz_s(chip, bpn)
            == ref_roofline.speed_of_light_nnz_s(ref_chip, bpn))


class _Props:
    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("name,bw,key", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, "h100-sxm"),
    ("NVIDIA H100 PCIe", 2.0e12, "h100-pcie"),
    ("NVIDIA H100 NVL", 3.9e12, "h100-nvl"),
])
def test_detect_chip_maps_the_h100_names(monkeypatch, name, bw, key):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props(name))
    spec = roofline.detect_chip()
    assert spec.name == key and spec.hbm_bw_bytes_s == bw
    assert spec.l2_bytes == 50 * 2**20
    assert (spec.f32_flops, spec.f64_flops) == (67e12, 34e12)


def test_detect_chip_unknown_card_warns(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props("Some Other GPU"))
    caplog.set_level("WARNING", logger="cfs_spmv_tpu_torch")
    spec = roofline.detect_chip()
    assert spec.name == "h100-sxm"
    assert "Some Other GPU" in caplog.text and "assuming" in caplog.text


def test_detect_chip_without_cuda_is_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.detect_chip().name == "cpu"


def _small(dtype=np.float32):
    coo = COO.random(800, 800, 5.0, symmetric=True, bandwidth=40, seed=0)
    return CSR.from_coo(coo)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_time_matvec_cpu_spdmv(dtype):
    A = SparseMatrix.create(_small(), Format.SSS)
    op = SpDMV(A, dtype=dtype, device="cpu")
    x = np.ones(A.ncols, dtype)
    t = timing.time_matvec(op, x, iters=3, repeats=2)
    assert isinstance(t, float) and 0 < t < 10
    # a 2-D x times the SpMM applier
    t_mm = timing.time_matvec(op, np.ones((A.ncols, 3), dtype), iters=2,
                              repeats=2)
    assert 0 < t_mm < 10


@pytest.mark.parametrize("x_dtype", [torch.float64, torch.float32])
def test_time_matvec_moves_a_tensor_to_the_operator(x_dtype):
    """A tensor x of another type than the operator's is cast to it, as
    ``SpDMV.__call__`` and the solvers cast it: a float64 tensor for a
    float32 ``cant_proxy()``-class operator times, and the apply it times
    is the one ``SpDMV`` makes of the same x."""
    from cfs_spmv_tpu_torch.utils.proxies import cant_proxy

    A = SparseMatrix.create(cant_proxy(n=600), Format.SSS)
    op = SpDMV(A, device="cpu")
    x = torch.ones(A.ncols, dtype=x_dtype)
    t = timing.time_matvec(op, x, iters=2, repeats=2)
    assert isinstance(t, float) and 0 < t < 10
    t_mm = timing.time_matvec(op, torch.ones((A.ncols, 2), dtype=x_dtype),
                              iters=2, repeats=2)
    assert 0 < t_mm < 10
    assert op(x).dtype == torch.float32


def test_as_pure_unwraps_every_form():
    A = SparseMatrix.create(_small(), Format.SSS)
    op = SpDMV(A, device="cpu")
    t = A.tuned
    for obj in (op, A, t, t.matvec):
        fn, ops, enc, dec = timing.as_pure(obj)
        assert fn is t.pure_apply()[0] and enc == t.encode
        fn_mm, _, _, _ = timing.as_pure(obj, torch.ones((A.ncols, 2)))
        assert fn_mm is t.pure_apply_mm()[0]
        assert timing.operator_space(obj) == (torch.float32,
                                              torch.device("cpu"))
    fn, ops, enc, dec = timing.as_pure(lambda v: 2 * v)
    assert ops == () and enc(3) == 3 and fn(ops, torch.ones(2))[0] == 2
    like = torch.ones(2, dtype=torch.float64)
    assert timing.operator_space(lambda v: v, like) == (
        torch.float64, torch.device("cpu"))


@pytest.mark.parametrize("dtype,vb", [(np.float32, 4), (np.float64, 8)])
def test_report_spmv_with_t_iter(dtype, vb):
    t = tune(_small(), fmt=Format.SSS, dtype=dtype, device="cpu")
    rep = report_spmv(t, t_iter=10e-6)
    assert rep.nnz_per_s == t.nnz_full / 10e-6
    assert rep.gflops == 2 * t.nnz_full / 10e-6 / 1e9
    chip = roofline.detect_chip()
    bpn = roofline.spmv_bytes_per_nnz(value_bytes=vb, nnz=t.nnz_full,
                                      nrows=t.nrows, ncols=t.ncols,
                                      vector_bytes=vb)
    assert rep.sol_nnz_per_s == roofline.speed_of_light_nnz_s(chip, bpn)
    assert 0 < rep.sol_fraction
    assert "Gnnz/s" in str(rep) and rep.chip == chip.name


def test_report_spmv_xla_route_has_no_vals(monkeypatch):
    """The plain float64 route's plan has no ``vals``; the value size
    comes from the tuned matrix's type."""
    from cfs_spmv_tpu_torch.utils.config import config

    monkeypatch.setattr(config, "fp64_path", "xla")
    t = tune(_small(), fmt=Format.SSS, dtype=np.float64, device="cpu")
    assert not hasattr(t.plan, "vals")
    rep = report_spmv(t, t_iter=1e-5)
    bpn = roofline.spmv_bytes_per_nnz(value_bytes=8, nnz=t.nnz_full,
                                      nrows=t.nrows, ncols=t.ncols,
                                      vector_bytes=8)
    assert rep.sol_nnz_per_s == roofline.speed_of_light_nnz_s(
        roofline.detect_chip(), bpn)


def test_report_spmv_measures_without_t_iter():
    t = tune(_small(), fmt=Format.SSS, device="cpu")
    rep = report_spmv(t, torch.ones(t.ncols), iters=2)
    assert rep.t_iter_s > 0
    with pytest.raises(ValueError, match="need x"):
        report_spmv(t)


def test_profile_writes_a_trace(tmp_path):
    t = tune(_small(), fmt=Format.SSS, device="cpu")
    with profile(str(tmp_path)) as prof:
        t.matvec(torch.ones(t.ncols))
    assert prof is not None
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    coo = COO.random(
        500, 500, 4.0, symmetric=True, bandwidth=60, seed=11,
        dtype=np.float64,
    )
    p = tmp_path_factory.mktemp("cli") / "small_sym.mtx"
    write_mmf(p, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    return str(p)


def test_cli_bench_harness(mtx_path, capsys):
    assert run_bench_cli([mtx_path, "1", "6", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "preproc(sec):" in out and "gflops/s:" in out
    assert "devices: 1" in out and "roofline:" in out


def test_cli_bench_spmm(mtx_path, capsys):
    assert run_bench_cli([mtx_path, "1", "4", "--rhs", "8",
                          "--device", "cpu"]) == 0
    assert "SSS-MM8" in capsys.readouterr().out


def test_cli_bench_dp(mtx_path, capsys):
    assert run_bench_cli([mtx_path, "0", "4", "--dp", "--device", "cpu"]) == 0
    assert "format: CSR" in capsys.readouterr().out


@pytest.mark.parametrize("rival", ["3", "4"])
def test_cli_bench_rivals(mtx_path, rival, capsys):
    """Rival backends (reference codes 3=MKL/4=RSB → here a PyTorch
    sparse CSR product and a dense one)."""
    assert run_bench_cli([mtx_path, rival, "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("TORCH_CSR" if rival == "3" else "DENSE") in out


def test_cli_bench_usage_and_default_device(mtx_path, capsys):
    assert run_bench_cli([]) == 1
    assert "Usage" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_bench_cli([mtx_path, "1", "2"])  # --device defaults to cuda
