"""A run without ``--trace`` never turns the port's recorder on: every
span the program opens in it finds recording off, and the recorder holds
nothing afterwards (CPU sizes)."""

import pytest

from spmv_bench import harness

from .conftest import small_config


@pytest.mark.parametrize("name", ["hpcg256-cg", "hpcg256-spmv"])
def test_a_run_without_trace_leaves_the_recorder_off(bench, name,
                                                     monkeypatch):
    from cfs_spmv_tpu_torch.utils import trace

    trace.disable()
    trace.collect()
    seen = []
    real = trace.span

    def spy(*args, **kwargs):
        seen.append(trace.is_recording())
        return real(*args, **kwargs)

    monkeypatch.setattr(trace, "span", spy)
    out = harness.run_cell(bench, name, 7, 0.2, False, device="cpu",
                           cache=None, cfg=small_config(bench, name))
    assert out["correct"] is True
    assert seen and not any(seen)
    rec = trace.collect()
    assert rec.spans == [] and rec.counters == {}
