"""``correct`` against faults and against the control, at CPU sizes.

Each run skips the harness's look for a card and drives the rest of a run
(the program's plain twins on CPU tensors): a sound run comes out correct;
with the timed path broken underneath (an answer altered where it is
produced, a step that returns its state unchanged, half the batch left
out) it comes out not correct; and the control, the program's own path
in the next lower precision, reads over each cell's limit."""

import pytest
import torch

from cfs_spmv_tpu_torch.models import solvers, spdmv
from spmv_bench import control, harness, spec

from .conftest import small_config

CELLS = ["hpcg256-cg", "hpcg256-spmv", "hpcg256-spmm8"]


def _run(bench, name, seed=2**31 + 11):
    return harness.run_cell(bench, name, seed, 0.3, False, device="cpu",
                            cache=None, cfg=small_config(bench, name))


def _kind(bench, name):
    return spec.mix(spec.cell(bench, name)["traffic"])["kind"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(bench, name):
    out = _run(bench, name)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    (check,) = out["checks"].values()
    assert check["value"] <= check["limit"]
    assert list(out)[-1] == "checks"


def _apply_fault(monkeypatch, fault):
    call = spdmv.SpDMV.__call__

    def broken(self, x):
        y = call(self, x)
        if fault == "altered":
            y = y.clone()
            y[len(y) // 3] += 1e-3 * (1 + y[len(y) // 3].abs())
        elif fault == "unchanged":
            y = torch.as_tensor(x, dtype=y.dtype)
        elif fault == "half_batch":
            y = y.clone()
            y[:, y.shape[1] // 2:] = 0
        return y

    monkeypatch.setattr(spdmv.SpDMV, "__call__", broken)


def _cg_fault(monkeypatch, fault):
    cg = solvers.cg

    def broken(op, b, **kw):
        x, rn, hist = cg(op, b, **kw)
        if fault == "altered":
            x = x.clone()
            x[len(x) // 2] += 1e-3 * (1 + x[len(x) // 2].abs())
        elif fault == "unchanged":
            x = torch.zeros_like(x)  # the start, x0 = 0
        return x, rn, hist

    monkeypatch.setattr(solvers, "cg", broken)


FAULTS = [(c, f) for c in CELLS for f in ("altered", "unchanged")]
FAULTS.append(("hpcg256-spmm8", "half_batch"))


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, name,
                                            fault):
    if _kind(bench, name) == "cg":
        _cg_fault(monkeypatch, fault)
    else:
        _apply_fault(monkeypatch, fault)
    out = _run(bench, name)
    assert out["correct"] is False and out["failed"] > 0
    (check,) = out["checks"].values()
    assert not check["value"] <= check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_over_the_limit(bench, name):
    cfg = small_config(bench, name)
    seeds = [2**31 + 21, 2**31 + 22, 2**31 + 23]
    sound = control.readings(bench, name, seeds, 0.2, device="cpu", cfg=cfg)
    low = control.readings(bench, name, seeds, 0.2, control=True,
                           device="cpu", cfg=cfg)
    (limit,) = (v for k, v in cfg["limits"].items()
                if k == ("cg_x_err" if _kind(bench, name) == "cg"
                         else "apply_err"))
    assert max(sound.values()) < limit < min(low.values())
    # with room on both sides
    assert max(sound.values()) * 10 < limit
    assert limit * 3 < min(low.values())
