"""The traced window: ``torch.profiler`` over a fixed amount of the cell's
work, and the reduction of its trace to the numbers the per-layer
readers take (device busy time as the union of the card's intervals, time
and launches by kind, kernels replayed from CUDA graphs, idle gaps by what
the host was doing)."""

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


class Trace:
    """The events of one traced window, in seconds."""

    def __init__(self, events: list[dict], port_names=frozenset()):
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
            })
        self.host = [e for e in events
                     if e.get("cat") in _HOST and e.get("ph") == "X"
                     and e.get("name") != WINDOW]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals in the window, merged."""
        spans = sorted((max(e["ts"], self.t0),
                        min(e["ts"] + e["dur"], self.t1))
                       for e in self.device)
        merged = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self._busy()) / 1e6

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

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The device's idle time in the window by the host operation that
        ran at each gap's middle (the one that began last), summed by
        name: [name, seconds]."""
        busy = self._busy()
        edges = [self.t0] + [x for s, t in busy for x in (s, t)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
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


def record(work, tries: int = 3) -> Trace:
    """Run ``work()`` (which ends on the card's synchronisation) under the
    profiler and read its trace. A window now and then comes back without
    device events: it is run again, up to ``tries`` windows, and then
    raises."""
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
        tr = Trace(events, names)
        if tr.device:
            return tr
    raise RuntimeError(f"the profiler saw no device events in {tries} "
                       "windows")
