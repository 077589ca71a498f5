"""Finds everything a run needs by name: the cell and the metrics in
``BENCHMARK.json``, the configuration's file, the traffic mix
(``mixes/<name>.json``), the matrix generator (``generators/<name>.py``)
and each metric's reader (``metrics/<name>.py``). A later cell, mix,
generator or metric is a file of its own and an entry; nothing here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class SpecError(LookupError):
    """A name that ``BENCHMARK.json`` or this folder does not hold."""


def _checked(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise SpecError(f"bad {kind} name {name!r}")
    return name


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SpecError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def _entry(entries: list, kind: str, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    known = ", ".join(e["name"] for e in entries)
    raise SpecError(f"unknown {kind} {name!r}; BENCHMARK.json has: {known}")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], "workload", _checked("workload", name))


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration ``name`` as its file holds it."""
    entry = _entry(bench["configs"], "configuration",
                   _checked("configuration", name))
    path = os.path.join(root, entry["file"])
    if not os.path.exists(path):
        raise SpecError(f"configuration {name!r}: no file {entry['file']}")
    with open(path) as f:
        return json.load(f)


def _file(kind: str, folder: str, name: str, ext: str) -> str:
    path = os.path.join(HERE, folder, _checked(kind, name) + ext)
    if not os.path.exists(path):
        raise SpecError(f"unknown {kind} {name!r}: no "
                        f"spmv_bench/{folder}/{name}{ext}")
    return path


def mix(name: str) -> dict:
    """The traffic mix ``name``: ``mixes/<name>.json``."""
    with open(_file("traffic mix", "mixes", name, ".json")) as f:
        return json.load(f)


def _module(kind: str, folder: str, name: str):
    path = _file(kind, folder, name, ".py")
    modspec = importlib.util.spec_from_file_location(
        f"spmv_bench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(modspec)
    modspec.loader.exec_module(mod)
    return mod


def generator(name: str):
    """The matrix generator ``generators/<name>.py``."""
    return _module("generator", "generators", name)


def reader(name: str):
    """The reader of metric ``name``: ``read`` of ``metrics/<name>.py``,
    which takes a run's record and returns its value, or None where the
    run holds nothing to read."""
    return _module("metric", "metrics", name).read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: with ``trace`` the
    per-layer metrics, else the end-to-end ones. A metric with a
    ``workloads`` key belongs to the cells it lists; a per-layer metric
    without one to every cell that reports the metric it moves, an
    end-to-end one without one to every cell."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
