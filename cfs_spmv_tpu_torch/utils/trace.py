"""Profiling, the port's spans and counters, and per-kernel roofline
reporting.

Port of ``cfs_spmv_tpu/utils/trace.py``. The reference's observability is
phase timing behind ``_REPORT_DETAILS`` (``csr_matrix.tpp:1641-1681``);
here a ``torch.profiler`` trace (a Chrome trace, viewable in Perfetto or
``chrome://tracing``), the card's busy time from the profiler's device
events, a roofline report per tuned operator, and one recorder of spans
and counters that the port's layers write into:

>>> with recording():
...     SpDMV(A, dtype=np.float64)(x); torch.cuda.synchronize()
>>> rec = collect()
>>> rec.seconds("cfs.tune.upload"), rec.counters["upload.bytes"]

- :func:`span` times a step (``cfs.<layer>.<step>``) on the host's
  ``time.perf_counter_ns`` clock and records its attributes, its id, its
  parent's (the innermost span open when it began) and its root's: every
  span of one solve, one apply or one ``tune`` shares the root's id;
- :func:`count` adds to a named counter;
- :func:`recording` (or :func:`enable` / :func:`disable`) turns both on,
  and :func:`collect` hands over and clears what they hold.

Recording is off by default: then a span tests one flag and returns one
shared object that does nothing, and a count returns at once. Inside an
active ``torch.profiler`` window a recorded span also enters
``torch.profiler.record_function`` under its name, so its interval lands
in the trace as a ``user_annotation`` on the device events' own clock
(:func:`profile` records for its block). With
``config.log_info`` (``CFS_LOG``), a span marked ``log=True`` writes one
INFO line with its seconds when it ends, recording or not. One thread
records at a time: the open spans are one stack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time

from . import roofline
from .config import config
from .logging import info

__all__ = ["profile", "device_busy_s", "RooflineReport", "report_spmv",
           "span", "count", "recording", "enable", "disable", "collect",
           "is_recording", "Span", "Record"]

#: whether spans and counters record (:func:`enable`, :func:`recording`)
_on = False
_spans: list = []
_counters: dict = {}
_open: list = []
_ids = itertools.count(1)


@dataclasses.dataclass
class Span:
    """One finished span: ``t0``/``t1`` in ``time.perf_counter_ns``;
    ``parent`` the id of the innermost span open when it began (None for
    a root), ``root`` the id of its outermost."""

    name: str
    attrs: dict
    id: int
    parent: int | None
    root: int
    t0: int
    t1: int

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


@dataclasses.dataclass
class Record:
    """What :func:`collect` hands over: the finished spans, in the order
    they ended, and the counters."""

    spans: list
    counters: dict

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> float | None:
        """Summed seconds of the spans called ``name``; None where there is
        none."""
        found = self.named(name)
        return sum(s.seconds for s in found) if found else None

    def children(self, parent: Span) -> list:
        return [s for s in self.spans if s.parent == parent.id]

    def descendants(self, root: Span) -> list:
        """The spans under ``root``, at any depth."""
        under, out = {root.id}, []
        for s in sorted(self.spans, key=lambda s: s.id):  # parents first
            if s.parent in under:
                under.add(s.id)
                out.append(s)
        return out


class _Null:
    """The span of a step nobody records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def wrote(self, t):
        return t


_NULL = _Null()


def _profiling() -> bool:
    import torch

    enabled = getattr(torch._C._autograd, "_profiler_enabled", None)
    return True if enabled is None else bool(enabled())


class _Open:
    """A span being timed (recorded where ``keep``, logged where
    ``log``)."""

    __slots__ = ("name", "attrs", "log", "keep", "id", "parent", "root",
                 "t0", "annotation")

    def __init__(self, name, attrs, log, keep):
        self.name, self.attrs, self.log, self.keep = name, attrs, log, keep
        self.annotation = None

    # the interval holds the span's own bookkeeping and annotation, so
    # that a parent's self time does not take in its children's
    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        if self.keep:
            up = _open[-1] if _open else None
            self.id = next(_ids)
            self.parent = None if up is None else up.id
            self.root = self.id if up is None else up.root
            _open.append(self)
            if _profiling():
                from torch.profiler import record_function

                self.annotation = record_function(self.name)
                self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.keep:
            # spans left open above this one (a block that raised) close
            # with it
            while _open and _open.pop() is not self:
                pass
        t1 = time.perf_counter_ns()
        if self.keep:
            _spans.append(Span(self.name, self.attrs, self.id, self.parent,
                               self.root, self.t0, t1))
        if self.log:
            extra = "".join(f" {k}={v}" for k, v in self.attrs.items())
            info("%s %.1fs%s", self.name, (t1 - self.t0) / 1e9, extra)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the block."""
        self.attrs.update(attrs)

    def wrote(self, t):
        """Add the bytes of the tensor ``t`` to the span's ``bytes`` (what
        the step wrote) and return ``t``."""
        self.attrs["bytes"] = self.attrs.get("bytes", 0) + t.nbytes
        return t


def span(name: str, log: bool = False, **attrs):
    """A context manager that times the enclosed step as the span
    ``name`` with ``attrs``, while recording is on (and, with ``log`` and
    ``CFS_LOG``, logs its seconds); else one shared object that does
    nothing. Either yields an object with ``set(**attrs)`` and
    ``wrote(tensor)``."""
    if not _on:
        if log and config.log_info:
            return _Open(name, attrs, True, False)
        return _NULL
    return _Open(name, attrs, log, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def is_recording() -> bool:
    return _on


@contextlib.contextmanager
def recording():
    """Record spans and counters in the enclosed block (then back to the
    state before it)."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def collect() -> Record:
    """The spans and counters recorded so far, which are cleared."""
    global _spans, _counters
    rec = Record(_spans, _counters)
    _spans, _counters = [], {}
    return rec


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
    one) and write it to ``logdir/trace.json``; the port's spans record
    meanwhile, so the trace shows them as ``user_annotation`` events:

    >>> with profile("/tmp/trace"):
    ...     spmv(x); torch.cuda.synchronize()

    Yields the ``torch.profiler.profile`` object.
    """
    from torch.profiler import profile as torch_profile

    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=_activities()) as prof, recording():
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
        from .timing import time_matvec

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
