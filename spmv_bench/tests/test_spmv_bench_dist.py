"""A configuration that runs ``DistSpDMV`` across a cell's cards, at CPU
sizes: four row shards on the CPU (``parallel/mesh.make_mesh(4,
device="cpu")``) through the harness's own run; an answer altered on one
shard's rows; the refusal of an operator that does not fit the cell's
cards; and a multi-card configuration with its own reference added as
files and entries alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cfs_spmv_tpu_torch.parallel import dist
from spmv_bench import harness, spec

from .conftest import ROOT, small_config

#: the cells of a four-card configuration, by their mix
DIST = {"d4-cg": "cg50", "d4-spmv": "spmv", "d4-spmm8": "spmm8"}


def _dist_bench(bench):
    """``bench`` with the four-card cells of ``DIST``, each in the
    end-to-end metrics its kind reports."""
    bench = json.loads(json.dumps(bench))
    for name, mix in DIST.items():
        bench["workloads"].append({"name": name, "config": "hpcg-256",
                                   "traffic": mix, "chips": 4, "why": "-"})
        moved = "cg_iter_ms" if mix == "cg50" else "apply_gflop_s"
        for m in bench["end_to_end"]:
            if m["name"] == moved:
                m["workloads"].append(name)
    return bench


def _dist_config(bench):
    return {**small_config(bench, "hpcg256-cg"),
            "nx": 16, "ny": 16, "nz": 16, "operator": "DistSpDMV",
            "dist": {"comm": "auto", "assign": "contiguous"}}


def _run(bench, name, seed=2**31 + 41):
    return harness.run_cell(_dist_bench(bench), name, seed, 0.3, False,
                            device="cpu", cache=None,
                            cfg=_dist_config(bench))


@pytest.mark.parametrize("name", sorted(DIST))
def test_a_four_shard_cell_runs_correct(bench, monkeypatch, name):
    shards = []
    run = dist.DistSpDMV._run

    def spy(self, ops, x, plain=False):
        shards.append(len(ops))
        return run(self, ops, x, plain)

    monkeypatch.setattr(dist.DistSpDMV, "_run", spy)
    out = _run(bench, name)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["attempted"] > 0
    assert shards and set(shards) == {4}  # the timed path, four shards
    moved = "cg_iter_ms" if DIST[name] == "cg50" else "apply_gflop_s"
    assert set(out["metrics"]) == {"setup_s", moved}


@pytest.mark.parametrize("name", sorted(DIST))
def test_an_answer_altered_on_one_shard_is_not_correct(bench, monkeypatch,
                                                       name):
    for method in ("_shard_apply", "_shard_apply_mm"):
        real = getattr(dist.DistSpDMV, method)

        def broken(self, sh, d, x, segs, plain, real=real):
            y = real(self, sh, d, x, segs, plain)
            if d == 1:  # one row of shard 1's own
                y = y.clone()
                y[7] += 1e-3 * (1 + y[7].abs())
            return y

        monkeypatch.setattr(dist.DistSpDMV, method, broken)
    out = _run(bench, name)
    assert out["correct"] is False and out["failed"] > 0
    (check,) = out["checks"].values()
    assert not check["value"] <= check["limit"]


@pytest.mark.parametrize("operator, chips, message", [
    ("SpDMV", 4, "SpDMV takes one card"),
    ("DistSpDMV", 1, "DistSpDMV more than one"),
    ("SpMV", 1, "unknown operator"),
])
def test_an_operator_that_does_not_fit_the_cards_is_refused(
        bench, operator, chips, message):
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "x-y", "config": "hpcg-256",
                               "traffic": "spmv", "chips": chips,
                               "why": "-"})
    cfg = {**small_config(bench, "hpcg256-spmv"), "operator": operator}
    with pytest.raises(spec.SpecError, match=message):
        harness.run_cell(bench, "x-y", 1, 0.1, False, device="cpu",
                         cache=None, cfg=cfg)


@pytest.mark.parametrize("device, chips, want", [
    ("cpu", 4, []),
    ("cuda", 1, ["cuda:0"]),
    ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:0", 4, ["cuda:0"]),
])
def test_the_cards_of_a_cell(device, chips, want):
    assert harness.cards(device, chips) == [torch.device(d) for d in want]


#: a plain reference of a configuration's own, as a later one adds it:
#: the product from the lower triangle by ``index_add_``, with no matrix
#: built; it marks its use beside itself
LEAN_REFERENCE = '''
"""HPCG's product from the benchmark's lower triangle, in float64."""

import os

import numpy as np
import torch


class Reference:
    def __init__(self, mat, device):
        with open(os.path.join(os.path.dirname(__file__), "used"), "a") as f:
            f.write("used\\n")
        self.rows = torch.repeat_interleave(
            torch.arange(mat.n), torch.as_tensor(np.diff(mat.indptr))
        ).to(device)
        self.cols = torch.as_tensor(mat.indices, device=device).long()
        self.vals = torch.as_tensor(mat.data, dtype=torch.float64,
                                    device=device)
        self.off = self.rows != self.cols

    def matvec(self, x, absolute=False):
        x = x.to(torch.float64)
        v = self.vals.abs() if absolute else self.vals
        x = x.abs() if absolute else x
        w = v if x.ndim == 1 else v[:, None]
        y = torch.zeros_like(x)
        y.index_add_(0, self.rows, w * x[self.cols])
        y.index_add_(0, self.cols[self.off],
                     w[self.off] * x[self.rows[self.off]])
        return y

    def cg(self, b, iters):
        b = b.to(torch.float64)
        x, r = torch.zeros_like(b), b.clone()
        p, rs = r.clone(), torch.dot(r, r)
        for _ in range(iters):
            ap = self.matvec(p)
            alpha = rs / torch.dot(p, ap)
            x += alpha * p
            r -= alpha * ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
        return x
'''


def test_a_multi_card_configuration_needs_no_edit(tmp_path):
    """A copy of the benchmark gets a configuration that runs DistSpDMV
    with a reference of its own, and two four-card cells of it, as files
    and entries alone; both run correct, and no file it had changes."""
    shutil.copytree(os.path.join(ROOT, "spmv_bench"),
                    tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    here = tmp_path / "spmv_bench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "references").mkdir(exist_ok=True)
    (here / "references" / "hpcg27_lean.py").write_text(LEAN_REFERENCE)
    (here / "configs" / "hpcg-16-x4.json").write_text(json.dumps({
        "name": "hpcg-16-x4", "precision": "float64",
        "generator": "hpcg27", "nx": 16, "ny": 16, "nz": 16,
        "operator": "DistSpDMV", "dist": {"comm": "halo"},
        "reference": "hpcg27_lean", "control": {"dtype": "float32"},
        "limits": {"apply_err": 1e-10, "cg_x_err": 1e-10}}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "hpcg-16-x4", "source": "-",
                             "file": "spmv_bench/configs/hpcg-16-x4.json",
                             "reduced": [], "why": "-"})
    for name, mix, moved in (("hpcg16-cg-dist4", "cg50", "cg_iter_ms"),
                             ("hpcg16-spmv-dist4", "spmv",
                              "apply_gflop_s")):
        bench["workloads"].append({"name": name, "config": "hpcg-16-x4",
                                   "traffic": mix, "chips": 4, "why": "-"})
        next(m for m in bench["end_to_end"]
             if m["name"] == moved)["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from spmv_bench import harness, spec;"
        "b = spec.load_benchmark(sys.argv[1]);"
        "print(json.dumps([harness.run_cell(b, n, 9, 0.2, False,"
        " device='cpu', cache=None, root=sys.argv[1])"
        " for n in ('hpcg16-cg-dist4', 'hpcg16-spmv-dist4')]))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT  # the program, from the repository
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    outs = json.loads(res.stdout.strip().splitlines()[-1])
    assert [o["correct"] for o in outs] == [True, True]
    assert set(outs[0]["metrics"]) == {"setup_s", "cg_iter_ms"}
    assert set(outs[1]["metrics"]) == {"setup_s", "apply_gflop_s"}
    # CG's right-hand sides and both checks came from the named reference
    used = (here / "references" / "used").read_text().split()
    assert len(used) == 3
    assert {p: p.read_bytes() for p in before} == before
