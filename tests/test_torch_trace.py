"""The port's recorder (``utils/trace``): spans and counters are off by
default and then record nothing; on, a solve, an apply and a ``tune`` each
give one root span whose steps are its children; the plan cache counts its
hits and misses; a float64 ``tune`` counts whether its plan peeled
diagonals; ``log=True`` spans keep the planners' INFO lines; and a
``profile()`` trace carries the spans as annotations on the device's
clock. CPU only."""

import json
import logging

import numpy as np
import pytest
import torch

from cfs_spmv_tpu_torch import COO, Format, SparseMatrix, SpDMV
from cfs_spmv_tpu_torch.models import solvers
from cfs_spmv_tpu_torch.tuning.tune import tune
from cfs_spmv_tpu_torch.utils import proxies, trace
from cfs_spmv_tpu_torch.utils.config import config


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Each test starts and ends with the recorder off and empty."""
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


def _matrix(n=600, seed=3):
    coo = COO.random(n, n, 5.0, symmetric=True, bandwidth=40, seed=seed,
                     dtype=np.float64)
    return SparseMatrix.create(coo, Format.SSS)


def _b(A):
    return torch.linspace(-1, 1, A.ncols, dtype=torch.float64)


def test_off_by_default_records_nothing():
    assert not trace.is_recording()
    A = _matrix()
    op = SpDMV(A, dtype=np.float64, device="cpu", cache_dir="")
    op(_b(A))
    solvers.cg(op, _b(A), iters=3)
    trace.count("anything", 5)
    rec = trace.collect()
    assert rec.spans == [] and rec.counters == {}


def test_off_span_is_one_shared_object():
    a, b = trace.span("cfs.a"), trace.span("cfs.b", rhs=1)
    assert a is b
    with a as s:
        assert s.wrote(torch.ones(2)).shape == (2,)
        s.set(bytes=1)


def test_recording_restores_the_state_before():
    with trace.recording():
        assert trace.is_recording()
        with trace.recording():
            pass
        assert trace.is_recording()
    assert not trace.is_recording()
    trace.enable()
    with trace.recording():
        pass
    assert trace.is_recording()


def test_cg_is_one_root_with_its_steps_as_children():
    A = _matrix()
    op = SpDMV(A, dtype=np.float64, device="cpu", cache_dir="")
    b = _b(A)
    with trace.recording():
        solvers.cg(op, b, iters=4)
    rec = trace.collect()
    roots = rec.named("cfs.solve")
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"solver": "cg", "iters": 4}
    steps = [s.name for s in rec.children(root)]
    assert steps == ["cfs.solve.setup", "cfs.solve.setup",
                     "cfs.solve.replay", "cfs.solve.finish"]
    assert all(s.root == root.id for s in rec.spans)
    for s in rec.descendants(root):
        assert root.t0 <= s.t0 <= s.t1 <= root.t1
    # the applies inside the solve are its stages, not user calls
    assert not rec.named("cfs.apply")
    assert {s.attrs["op"] for s in rec.named("cfs.stage")} >= {"pad_x"}
    assert "cuda.device_allocs" in rec.counters


@pytest.mark.parametrize("solver, kw", [
    ("power_iteration", {"iters": 3}),
    ("gmres", {"restart": 4, "outer": 2}),
])
def test_every_solver_is_a_root(solver, kw):
    A = _matrix()
    op = SpDMV(A, dtype=np.float64, device="cpu", cache_dir="")
    fn = getattr(solvers, solver)
    args = (A.nrows,) if solver == "power_iteration" else (_b(A),)
    with trace.recording():
        fn(op, *args, **kw)
    rec = trace.collect()
    (root,) = rec.named("cfs.solve")
    assert root.attrs["solver"] == solver
    assert root.attrs["iters"] == kw.get("iters", kw.get("outer"))
    assert rec.children(root)[0].name == "cfs.solve.setup"


def test_apply_is_one_root_per_call():
    A = _matrix()
    op = SpDMV(A, dtype=np.float64, device="cpu", cache_dir="")
    x = _b(A)
    with trace.recording():
        op(x)
        A @ x
        A.tuned.matvec(x)
        op(torch.stack([x, x], 1))
    rec = trace.collect()
    applies = rec.named("cfs.apply")
    assert [s.attrs["rhs"] for s in applies] == [1, 1, 1, 2]
    assert all(s.parent is None for s in applies)
    for s in rec.named("cfs.stage"):
        assert s.attrs["bytes"] > 0
        assert s.root in {a.id for a in applies}


def test_tune_counts_misses_then_hits(tmp_path):
    A = _matrix(seed=5)
    with trace.recording():
        tune(A.csr, fmt=Format.SSS, dtype=np.float64, device="cpu",
             cache_dir=str(tmp_path))
    rec = trace.collect()
    assert rec.counters["plancache.misses"] == 1
    assert "plancache.hits" not in rec.counters
    (root,) = rec.named("cfs.tune")
    steps = {s.name for s in rec.children(root)}
    assert {"cfs.tune.key", "cfs.tune.plan_build", "cfs.tune.plan_save",
            "cfs.tune.upload"} <= steps
    assert rec.counters["upload.bytes"] == sum(
        s.attrs["bytes"] for s in rec.named("cfs.tune.upload")) > 0

    with trace.recording():
        tune(A.csr, fmt=Format.SSS, dtype=np.float64, device="cpu",
             cache_dir=str(tmp_path))
    rec = trace.collect()
    assert rec.counters["plancache.hits"] == 1
    assert "plancache.misses" not in rec.counters
    assert rec.named("cfs.tune.plan_load")
    assert not rec.named("cfs.tune.plan_build")
    assert not rec.named("cfs.plan.layout")


def test_a_log_span_writes_one_info_line(monkeypatch, caplog):
    monkeypatch.setattr(config, "log_info", True)
    caplog.set_level(logging.INFO, logger="cfs_spmv_tpu_torch")
    with trace.span("cfs.plan.test", log=True, n=7):
        pass
    with trace.span("cfs.plan.quiet"):
        pass
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1
    assert lines[0].startswith("cfs.plan.test ") and "n=7" in lines[0]
    assert trace.collect().spans == []  # logged, not recorded


def test_a_log_span_is_silent_without_cfs_log(monkeypatch, caplog):
    monkeypatch.setattr(config, "log_info", False)
    caplog.set_level(logging.INFO, logger="cfs_spmv_tpu_torch")
    assert trace.span("cfs.plan.test", log=True) is trace.span("cfs.x")
    with trace.span("cfs.plan.test", log=True):
        pass
    assert not caplog.records


def test_a_raising_block_closes_its_spans():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("cfs.outer"):
                with trace.span("cfs.inner"):
                    raise ValueError("x")
        with trace.span("cfs.after"):
            pass
    rec = trace.collect()
    assert rec.named("cfs.after")[0].parent is None
    assert rec.named("cfs.inner")[0].parent == rec.named("cfs.outer")[0].id


def test_profile_trace_holds_the_spans(tmp_path):
    A = _matrix()
    op = SpDMV(A, dtype=np.float64, device="cpu", cache_dir="")
    with trace.profile(str(tmp_path)):
        op(_b(A))
    assert not trace.is_recording()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events
             if e.get("cat") == "user_annotation"}
    assert {"cfs.apply", "cfs.stage"} <= names


def _scattered_symmetric(n=2048, seed=7):
    """Six scattered strict-lower entries a row and the main diagonal: no
    diagonal dense enough to peel."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(1, n, dtype=np.int64), 6)
    col = (rng.random(len(row)) * row).astype(np.int64)
    row = np.concatenate([row, np.arange(n)])
    col = np.concatenate([col, np.arange(n)])
    coo = COO(n, n, row, col, rng.uniform(-1, 1, len(row)), symmetric=True)
    return SparseMatrix.create(coo.canonicalize(), Format.SSS)


@pytest.mark.parametrize("name, peeled, plan, diagonals", [
    ("stencil27", 1, "sdia", 14),
    ("scattered_symmetric", 0, "expanded", 0),
])
def test_tune_counts_the_fp64_peel(name, peeled, plan, diagonals):
    A = (SparseMatrix.create(proxies.stencil27(g=12, dtype=np.float64),
                             Format.SSS)
         if name == "stencil27" else _scattered_symmetric())
    with trace.recording():
        tune(A.csr, fmt=Format.SSS, dtype=np.float64, device="cpu",
             cache_dir="")
    rec = trace.collect()
    assert rec.counters["tune.fp64_peeled"] == peeled
    (root,) = rec.named("cfs.tune")
    assert root.attrs["fp64_plan"] == plan
    assert root.attrs["sdia_diagonals"] == diagonals
    # the diagonal count runs for a peeled plan only
    assert len(rec.named("cfs.tune.diag_count")) == peeled
