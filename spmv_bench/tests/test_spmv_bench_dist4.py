"""The cell ``hpcg128-cg-dist4`` (configuration ``hpcg-128-x4``): CG over
``DistSpDMV`` in four row shards, at a CPU size of 16^3 a rank (16 x 16 x
64), traced with the port's recorder on; its three readers of the
distributed layer, which read nothing without the recorder or without a
``DistSpDMV``; and, on a node of four cards, a short run of the cell as
the benchmark runs it."""

import os
import subprocess
import sys

import pytest
import torch

from spmv_bench import harness, spec
from spmv_bench import trace as tracing

from .conftest import ROOT, result_line, small_config
from .test_spmv_bench_trace import DEVICE, _events, _run

CELL = "hpcg128-cg-dist4"
READERS = ["cross_card_mb_per_iter.cg", "dist_host_us_per_iter.cg",
           "dist_plan_s"]
#: an apply's bytes between cards at 16^3 a rank: shards 1-3's x
#: segments out and y rows back (4,096 rows each) and six 256-row halos,
#: float64; a CG solve of 50 iterations applies 51 times
APPLY_BYTES = (2 * 3 * 4096 + 6 * 256) * 8


def _small(bench):
    cfg = spec.config(bench, spec.cell(bench, CELL)["config"])
    return {**cfg, "nx": 16, "ny": 16, "nz": 64}


@pytest.mark.parametrize("cards", [1, 4])
def test_a_traced_run_reads_the_distributed_layer(bench, monkeypatch,
                                                  cards):
    """Four shards on one CPU device (the exchanges are views: no byte
    crosses a card) or on a mesh of four distinct CPU devices (every
    copy between shards crosses one); the profiler's window stood in for
    by synthetic events (the CPU has no device events)."""
    from cfs_spmv_tpu_torch.parallel import mesh

    def record(work, tries=3, cards=1):
        work()
        return tracing.Trace(_events(DEVICE), cards=cards)

    monkeypatch.setattr(tracing, "record", record)
    if cards == 4:
        monkeypatch.setattr(mesh, "make_mesh", lambda n, device: mesh.Mesh(
            tuple(torch.device("cpu", i) for i in range(n))))
    out = harness.run_cell(bench, CELL, 2**31 + 77, 0.3, True,
                           device="cpu", cache=None, cfg=_small(bench))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == set(READERS)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    want = APPLY_BYTES * 51 / 50 / 1e6 if cards == 4 else 0.0
    assert got["cross_card_mb_per_iter.cg"] == pytest.approx(want)
    assert got["dist_host_us_per_iter.cg"] > 0 and got["dist_plan_s"] > 0
    assert {v["unit"] for v in out["metrics"].values()} == {"MB", "us", "s"}


def test_the_cell_s_end_to_end_metrics_without_trace(bench):
    out = harness.run_cell(bench, CELL, 5, 0.2, False, device="cpu",
                           cache=None, cfg=_small(bench))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "cg_iter_ms"}


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_without_the_recorder(name):
    run = _run(tracing.Trace(_events(DEVICE)), 4, kind="cg")
    assert run.setup_record is None and run.window_record is None
    assert spec.reader(name)(run) is None


def test_the_readers_read_nothing_of_a_one_card_program(bench, monkeypatch):
    """A solve over ``SpDMV`` records no ``cfs.dist`` span or counter: the
    readers of the distributed layer read nothing there."""

    def record(work, tries=3, cards=1):
        work()
        return tracing.Trace(_events(DEVICE), cards=cards)

    monkeypatch.setattr(tracing, "record", record)
    captured = {}
    real = harness._result

    def keep(run, *args):
        captured["run"] = run
        return real(run, *args)

    monkeypatch.setattr(harness, "_result", keep)
    harness.run_cell(bench, "hpcg256-cg", 11, 0.2, True, device="cpu",
                     cache=None, cfg=small_config(bench, "hpcg256-cg"))
    run = captured["run"]
    assert run.window_record is not None and run.setup_record is not None
    assert [spec.reader(name)(run) for name in READERS] == [None] * 3


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_four_cards(card, trace):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    res = subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload", CELL,
         "--seed", "2147484011", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr[-4000:]
    out = result_line(res.stdout)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    want = {m["name"] for m in spec.metrics_for(spec.load_benchmark(), CELL,
                                                bool(trace))}
    assert set(out["metrics"]) == want
