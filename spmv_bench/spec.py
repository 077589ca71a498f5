"""Finds everything a run needs by name: the cell and the metrics in
``BENCHMARK.json``, the configuration's file, the traffic mix
(``mixes/<name>.json``), the matrix generator (``generators/<name>.py``),
a configuration's own plain reference (``references/<name>.py``), each
metric's reader (``metrics/<name>.py``), and the port's operator that a
configuration runs. A later cell, mix, generator, reference or metric is
a file of its own and an entry; nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
import re

from . import guard

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


def reference(name: str):
    """The class ``Reference`` of ``references/<name>.py``: a
    configuration's own plain reference, with the constructor
    ``Reference(mat, device)`` and the methods ``matvec(x)``,
    ``matvec(x, absolute=True)`` and ``cg(b, iters)`` of
    ``spmv_bench/reference.py``. A file that imports the port, JAX or the
    JAX package is refused before it runs."""
    path = _file("reference", "references", name, ".py")
    found = guard.imported(path) & (guard.FORBIDDEN | {guard.PORT})
    if found:
        raise SpecError(f"reference {name!r} imports "
                        f"{', '.join(sorted(found))}: a reference takes "
                        "nothing of the program")
    return _module("reference", "references", name).Reference


#: the port's operators a configuration may name (``"operator"``)
OPERATORS = ("SpDMV", "DistSpDMV")


def operator(cfg: dict, chips: int) -> str:
    """The port's operator that ``cfg`` runs (``"operator"``; default
    ``SpDMV``) in a cell of ``chips`` cards. ``SpDMV`` runs on one card,
    ``DistSpDMV`` shards the rows over the cell's cards: a cell of several
    cards on ``SpDMV`` would measure one card's work, and ``DistSpDMV`` in
    a cell of one card no exchange, so both are refused."""
    op = cfg.get("operator", "SpDMV")
    if op not in OPERATORS:
        raise SpecError(f"configuration {cfg.get('name')!r}: unknown "
                        f"operator {op!r}; the harness runs "
                        f"{', '.join(OPERATORS)}")
    if (op == "DistSpDMV") != (chips > 1):
        raise SpecError(f"configuration {cfg.get('name')!r} runs {op} in a "
                        f"cell of {chips} card(s): SpDMV takes one card, "
                        "DistSpDMV more than one")
    return op


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
