"""The check that a run loads no JAX, and the runs that must give no
result: without a card, and in a folder without the program."""

import os
import shutil
import subprocess
import sys

import pytest

from spmv_bench import guard

from .conftest import ROOT


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["cfs_spmv_tpu", "cfs_spmv_tpu.ops.spmv"], ["cfs_spmv_tpu"]),
    (["cfs_spmv_tpu_torch", "cfs_spmv_tpu_torch.ops.spmv"], []),
    (["jaxtyping", "flaxen", "cfs_spmv_tpu2", "torch"], []),
])
def test_top_level_names_are_compared_whole(names, found):
    assert guard.forbidden_loaded(names) == found


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "spmv_bench/run.py", "--workload", "hpcg256-spmv",
         "--seed", "3000000000", "--seconds", "1", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    res = _run(ROOT, "--trace", "0")
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "spmv_bench"),
                    tmp_path / "spmv_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    res = _run(str(tmp_path), "--trace", "1")
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_imports_are_read_by_top_level_name(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import numpy as np, os.path\n"
                   "from torch.nn import functional\n"
                   "from . import sibling\n"
                   "def f():\n"
                   "    import cfs_spmv_tpu_torch.ops\n")
    assert guard.imported(str(src)) == {"numpy", "os", "torch",
                                        "cfs_spmv_tpu_torch"}


def test_no_reference_imports_the_program_or_jax():
    here = os.path.join(ROOT, "spmv_bench")
    folder = os.path.join(here, "references")
    files = [os.path.join(here, "reference.py")] + sorted(
        os.path.join(folder, f) for f in
        (os.listdir(folder) if os.path.isdir(folder) else [])
        if f.endswith(".py"))
    for path in files:
        assert not guard.imported(path) & (guard.FORBIDDEN | {guard.PORT}), \
            path


@pytest.mark.parametrize("line, refused", [
    ("import torch", False),
    ("from cfs_spmv_tpu_torch.formats import csr", True),
    ("import jax.numpy as jnp", True),
    ("from cfs_spmv_tpu import ops", True),
])
def test_a_reference_that_imports_the_program_is_refused(
        tmp_path, monkeypatch, line, refused):
    from spmv_bench import spec

    (tmp_path / "references").mkdir()
    (tmp_path / "references" / "r.py").write_text(
        f"{line}\n\n\nclass Reference:\n    pass\n")
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    if refused:
        with pytest.raises(spec.SpecError, match="takes nothing"):
            spec.reference("r")
    else:
        assert spec.reference("r").__name__ == "Reference"
