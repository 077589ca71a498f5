"""Whole runs on the card: one short run of each cell and its traced run,
each correct, with every metric the cell reports. Skipped without a card;
on the card: ``python -m pytest spmv_bench/tests -q -m card``."""

import os
import subprocess
import sys

import pytest

from spmv_bench import spec

from .conftest import ROOT, result_line


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["hpcg256-cg", "hpcg256-spmv",
                                  "hpcg256-spmm8"])
def test_a_short_run_on_the_card(card, name, trace):
    res = subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload", name,
         "--seed", "2147483999", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr[-4000:]
    out = result_line(res.stdout)
    assert out["correct"] is True, out["checks"]
    want = {m["name"] for m in spec.metrics_for(spec.load_benchmark(), name,
                                                bool(trace))}
    if trace:
        assert set(out["metrics"]) <= want and out["metrics"]
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    else:
        assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "gpu"
