"""Profiling and per-kernel roofline reporting.

Port of ``cfs_spmv_tpu/utils/trace.py``. The reference's observability is
phase timing behind ``_REPORT_DETAILS`` (``csr_matrix.tpp:1641-1681``);
here a ``torch.profiler`` trace (a Chrome trace, viewable in Perfetto or
``chrome://tracing``), the card's busy time from the profiler's device
events, and a roofline report per tuned operator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

from . import roofline
from .timing import time_matvec

__all__ = ["profile", "device_busy_s", "RooflineReport", "report_spmv"]


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile(logdir: str):
    """Trace the enclosed block (the card's activity too, where there is
    one) and write it to ``logdir/trace.json``:

    >>> with profile("/tmp/trace"):
    ...     spmv(x); torch.cuda.synchronize()

    Yields the ``torch.profiler.profile`` object.
    """
    from torch.profiler import profile as torch_profile

    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_busy_s(fn, calls: int = 20) -> float | None:
    """Seconds per call of ``fn()`` that the card is busy (the summed
    durations of its kernels, copies and fills, from ``torch.profiler``),
    over ``calls`` calls after one warm-up call. A window now and then
    comes back without device events: it is tried again, up to three
    windows, and then the time was not measured: None, never 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / 1e6 / calls
    return None


@dataclasses.dataclass
class RooflineReport:
    """Per-operator performance against the bandwidth speed of light."""

    t_iter_s: float
    gflops: float
    nnz_per_s: float
    stream_bytes: int
    achieved_gb_s: float
    sol_nnz_per_s: float  # CSR-equivalent roofline (ref-comparable)
    sol_fraction: float
    chip: str

    def __str__(self):
        return (
            f"t/iter={self.t_iter_s * 1e6:.1f}us "
            f"{self.gflops:.1f} GFLOP/s {self.nnz_per_s / 1e9:.2f} Gnnz/s "
            f"| stream {self.stream_bytes / 1e6:.1f} MB @ "
            f"{self.achieved_gb_s:.0f} GB/s | "
            f"{100 * self.sol_fraction:.0f}% of CSR-roofline ({self.chip})"
        )


def report_spmv(tuned, x=None, *, t_iter: float | None = None,
                iters: int = 500) -> RooflineReport:
    """Measure (or accept) t/iter for a TunedMatrix and place it on the
    roofline. ``x`` is required when ``t_iter`` is not given. The value
    size is ``tuned.dtype``'s (every plan has one; not every plan has a
    ``vals`` array)."""
    if t_iter is None:
        if x is None:
            raise ValueError("need x to measure t_iter")
        t_iter = time_matvec(tuned.matvec, x, iters=iters)
    nnz = tuned.nnz_full
    chip = roofline.detect_chip()
    dtype_bytes = tuned.dtype.itemsize
    bpn = roofline.spmv_bytes_per_nnz(
        value_bytes=dtype_bytes, index_bytes=4, nnz=nnz,
        nrows=tuned.nrows, ncols=tuned.ncols, vector_bytes=dtype_bytes,
    )
    sol = roofline.speed_of_light_nnz_s(chip, bpn)
    sb = tuned.stream_bytes()
    return RooflineReport(
        t_iter_s=t_iter,
        gflops=2 * nnz / t_iter / 1e9,
        nnz_per_s=nnz / t_iter,
        stream_bytes=sb,
        achieved_gb_s=sb / t_iter / 1e9,
        sol_nnz_per_s=sol,
        sol_fraction=(nnz / t_iter) / sol,
        chip=chip.name,
    )
