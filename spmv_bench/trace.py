"""The traced window: ``torch.profiler`` over a fixed amount of the cell's
work, and the reduction of its trace to the numbers the per-layer
readers take (each card's busy time as the union of its intervals, time
and launches by kind, kernels replayed from CUDA graphs, idle gaps by what
the host was doing, idle time by the port's spans), and of the port's
recorded spans (``cfs_spmv_tpu_torch.utils.trace``: self time, seconds by
name)."""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

WINDOW = "spmv_bench.window"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
         "python_function")
#: the port's spans of a solve's preparation, before its replays
SOLVE_PREP = ("cfs.solve.setup", "cfs.solve.warmup", "cfs.solve.capture",
              "cfs.solve.restore")


def port_kernels() -> frozenset[str]:
    """The names of the port's hand-written kernels (each ``__global__``
    function of its CUDA source); empty where the source is not found."""
    import importlib.util

    found = importlib.util.find_spec("cfs_spmv_tpu_torch")
    if found is None or not found.submodule_search_locations:
        return frozenset()
    src = os.path.join(list(found.submodule_search_locations)[0], "csrc",
                       "spmv_kernels.cu")
    if not os.path.exists(src):
        return frozenset()
    with open(src) as f:
        text = f.read()
    return frozenset(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
        text))


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: ``sdia_sym_kernel<double, 1>``."""
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the argument list, past any template
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut].strip()
    if name.startswith("void "):
        name = name[5:]
    return name[:100]


def _card(e: dict) -> int:
    """The card a device event ran on."""
    return e.get("args", {}).get("device", e.get("pid", 0))


def _merged(spans) -> list[tuple[float, float]]:
    """Intervals, sorted and merged where they overlap or touch."""
    merged = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


class Trace:
    """The events of one traced window, in seconds, over ``cards`` cards."""

    def __init__(self, events: list[dict], port_names=frozenset(),
                 cards: int = 1):
        self.cards = cards
        spans = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError("the trace holds no window span")
        w = spans[0]
        self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]
        graph_corr = {e["args"].get("correlation") for e in events
                      if e.get("cat") == "cuda_runtime"
                      and e.get("name") == "cudaGraphLaunch"
                      and "args" in e}
        self.device = []
        for e in events:
            if e.get("cat") not in _DEVICE or e.get("ph") != "X":
                continue
            s, d = e["ts"], e.get("dur", 0)
            if s + d <= self.t0 or s >= self.t1:
                continue
            corr = e.get("args", {}).get("correlation")
            name = short_name(e["name"])
            self.device.append({
                "name": name, "ts": s, "dur": d,
                "port": name.split("<")[0] in port_names,
                "graph": corr is not None and corr in graph_corr,
                "card": _card(e),
            })
        self.host = [e for e in events
                     if e.get("cat") in _HOST and e.get("ph") == "X"
                     and e.get("name") != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _busy(self, events=None) -> list[tuple[float, float]]:
        """The union of the intervals of ``events`` (default: every
        card's) in the window, merged: where some card is busy."""
        return _merged((max(e["ts"], self.t0),
                        min(e["ts"] + e["dur"], self.t1))
                       for e in (self.device if events is None else events))

    def _by_card(self) -> dict:
        """The device events by card (all as one where the cell has one
        card)."""
        by = collections.defaultdict(list)
        for e in self.device:
            by[e["card"] if self.cards > 1 else 0].append(e)
        return by

    @property
    def busy_s(self) -> float:
        """Each card's busy seconds (the union of its intervals), mean over
        the cell's cards."""
        return sum(t - s for evs in self._by_card().values()
                   for s, t in self._busy(evs)) / 1e6 / self.cards

    def busiest_card_s(self) -> float:
        """Summed device time of the window's operations on the card that
        ran the most."""
        return max((sum(e["dur"] for e in evs)
                    for evs in self._by_card().values()), default=0) / 1e6

    def device_s(self, *, graph=None, port=None) -> float:
        """Summed device time of the window's operations, of those replayed
        from a CUDA graph (or not), of the port's kernels (or not)."""
        return sum(e["dur"] for e in self.device
                   if (graph is None or e["graph"] == graph)
                   and (port is None or e["port"] == port)) / 1e6

    def launches(self) -> int:
        """The device's operations in the window."""
        return len(self.device)

    @property
    def replayed(self) -> bool:
        """Whether the trace tells graph replays apart."""
        return any(e["graph"] for e in self.device)

    def device_ops(self, top: int = 10) -> list[list]:
        """The operations that took most device time: [name, seconds]."""
        by = collections.Counter()
        for e in self.device:
            by[e["name"]] += e["dur"] / 1e6
        return [[k, v] for k, v in by.most_common(top)]

    def _gaps(self) -> list[tuple[float, float]]:
        """The stretches of the window in which no card is busy."""
        busy = self._busy()
        edges = [self.t0] + [x for s, t in busy for x in (s, t)] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The idle time in the window (no card busy) by the host operation
        that ran at each gap's middle (the one that began last), summed by
        name: [name, seconds]."""
        gaps = self._gaps()
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        by = collections.Counter()
        for s, t in gaps:
            mid = (s + t) / 2
            label = "(no host operation)"
            last = bisect.bisect_right(starts, mid)
            # the latest-begun of the last 256 host operations that spans it
            for e in reversed(host[max(0, last - 256):last]):
                if e["ts"] + e.get("dur", 0) >= mid:
                    label = e["name"][:100]
                    break
            by[label] += (t - s) / 1e6
        return [[k, v] for k, v in by.most_common(top)]

    def idle_by_span(self, names) -> dict | None:
        """The idle seconds of the window (no card busy) by the innermost
        of the port's span annotations called one of ``names`` that was
        open on the host meanwhile: {name: seconds}, the idle time under
        none of them as None; None where the window holds no such
        annotation (the recorder was off). Each idle stretch is split
        where annotations begin and end: one clock, no alignment."""
        # by start, the outer of two that start together first
        spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                        for e in self.host
                        if e.get("cat") == "user_annotation"
                        and e.get("name") in names),
                       key=lambda s: (s[0], -s[1]))
        if not spans:
            return None
        starts = [s[0] for s in spans]
        cuts = sorted({x for a, b, _ in spans for x in (a, b)})
        out: dict = {}
        for g0, g1 in self._gaps():
            lo = bisect.bisect_right(cuts, g0)
            hi = bisect.bisect_left(cuts, g1)
            points = [g0, *cuts[lo:hi], g1]
            for a, b in zip(points, points[1:]):
                mid = (a + b) / 2
                key = None  # the latest-begun span open at mid
                for s in reversed(spans[:bisect.bisect_right(starts, mid)]):
                    if s[1] > mid:
                        key = s[2]
                        break
                out[key] = out.get(key, 0.0) + (b - a) / 1e6
        return out


def self_s(outer, inner) -> float:
    """Seconds of the recorded span ``outer`` that none of the spans
    ``inner`` covers: its duration less the union of their intervals
    clipped to it (an overlap counts once). Spans are the port's
    ``utils/trace.Span``, on ``time.perf_counter_ns``."""
    covered = _merged((max(s.t0, outer.t0), min(s.t1, outer.t1))
                      for s in inner if s.t1 > outer.t0 and s.t0 < outer.t1)
    return (outer.t1 - outer.t0 - sum(t - s for s, t in covered)) / 1e9


def span_s(record, name: str) -> float | None:
    """Summed seconds of the recorded spans called ``name``; None where
    there is no record or no such span."""
    found = [] if record is None else [s for s in record.spans
                                       if s.name == name]
    return sum((s.t1 - s.t0) / 1e9 for s in found) if found else None


def record(work, tries: int = 3, cards: int = 1) -> Trace:
    """Run ``work()`` (which ends on the cards' synchronisation) under the
    profiler and read its trace over ``cards`` cards. A window now and
    then comes back without device events: it is run again, up to
    ``tries`` windows, and then raises."""
    from torch.profiler import ProfilerActivity, profile, record_function

    names = port_kernels()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                work()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        tr = Trace(events, names, cards)
        if tr.device:
            return tr
    raise RuntimeError(f"the profiler saw no device events in {tries} "
                       "windows")
