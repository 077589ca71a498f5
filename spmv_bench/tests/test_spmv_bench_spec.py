"""Everything found by name: BENCHMARK.json against the files of this
folder, the errors that unknown names give, and a new mix and cell added
as files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from spmv_bench import harness, spec

from .conftest import ROOT, SMALL

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_every_cell_finds_its_files(bench):
    for cell in bench["workloads"]:
        cfg = spec.config(bench, cell["config"])
        mix = spec.mix(cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert mix["kind"] in ("apply", "cg")
        for check in (("apply_err",) if mix["kind"] == "apply"
                      else ("cg_x_err",)):
            assert cfg["limits"][check] > 0
        spec.generator(cfg["generator"])
        for trace in (False, True):
            wanted = spec.metrics_for(bench, cell["name"], trace)
            assert wanted
            for m in wanted:
                assert callable(spec.reader(m["name"]))
        names = {m["name"] for m in spec.metrics_for(bench, cell["name"],
                                                     False)}
        assert "setup_s" in names and len(names) >= 2


def test_the_benchmark_file_keeps_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    for key in ("configs", "workloads"):
        for e in bench[key]:
            assert 1 <= len(e["why"]) <= 200
            assert "\n" not in e["why"] and "\t" not in e["why"]
    for c in bench["configs"]:
        assert c["file"].startswith("spmv_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    assert all(w["chips"] == 1 for w in bench["workloads"])


@pytest.mark.parametrize("call, message", [
    (lambda b: spec.cell(b, "no-such-cell"), "unknown workload"),
    (lambda b: spec.config(b, "no-such-config"), "unknown configuration"),
    (lambda b: spec.mix("no-such-mix"), "unknown traffic mix"),
    (lambda b: spec.reader("no_such_metric"), "unknown metric"),
    (lambda b: spec.generator("no_such_generator"), "unknown generator"),
    (lambda b: spec.reference("no_such_reference"), "unknown reference"),
    (lambda b: spec.mix("../configs/hpcg-256"), "bad traffic mix name"),
])
def test_unknown_names_fail_with_a_message(bench, call, message):
    with pytest.raises(spec.SpecError, match=message):
        call(bench)


def test_a_cell_whose_mix_file_is_missing_fails(bench):
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "x-y", "config": "hpcg-256",
                               "traffic": "absent", "chips": 1, "why": "-"})
    with pytest.raises(spec.SpecError, match="unknown traffic mix"):
        harness.run_cell(bench, "x-y", 1, 0.1, False, device="cpu",
                         cache=None)


def test_a_new_mix_and_cell_need_no_edit(tmp_path):
    """A copy of the benchmark gets one more mix file and one more cell
    entry, and runs it: no file it had is changed."""
    shutil.copytree(os.path.join(ROOT, "spmv_bench"),
                    tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: open(p, "rb").read()
              for p in (tmp_path / "spmv_bench").rglob("*") if p.is_file()}
    (tmp_path / "spmv_bench" / "mixes" / "spmm4.json").write_text(
        json.dumps({"kind": "apply", "why": "four columns", "rhs": 4,
                    "pool": 3, "sample": 4}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "hpcg256-spmm4",
                               "config": "hpcg-256", "traffic": "spmm4",
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "apply_gflop_s" in (m["name"], m.get("moves")) \
                and "workloads" in m:
            m["workloads"].append("hpcg256-spmm4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from spmv_bench import harness, spec;"
        "b = spec.load_benchmark(sys.argv[1]);"
        "cfg = {**spec.config(b, 'hpcg-256', sys.argv[1]), **json.loads(sys.argv[2])};"
        "r = harness.run_cell(b, 'hpcg256-spmm4', 5, 0.2, False,"
        " device='cpu', cache=None, cfg=cfg, root=sys.argv[1]);"
        "print(json.dumps(r))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT  # the program, from the repository
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                          json.dumps(SMALL["hpcg-256"])],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "apply_gflop_s"}
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
