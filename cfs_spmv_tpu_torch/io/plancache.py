"""Tuned-plan serialization and content-addressed caching.

Host copy of ``cfs_spmv_tpu/io/plancache.py`` for the PyTorch port: the
same ``PLAN_VERSION``, the same ``.npz`` layout (arrays plus a JSON
manifest entry) and the same ``cache_key``, so the two packages read each
other's files and, given one ``cache_dir``, share it. The reference
re-parses the .mtx and re-runs the whole tuning pipeline on every process
start (``bench_spmv_mmf.cpp:145-148``); SURVEY §5 flags persisting the
tuned format as a designed improvement.

bfloat16 values. The file holds a bfloat16 array as its uint16 bits with
a ``"dtype": "bfloat16"`` tag, as the reference writes it. The port's host
plans hold such an array as those bits already (:data:`BF16_BITS`: numpy
has no bfloat16 without ``ml_dtypes``, which the port does not import),
so :func:`_flatten` tags every uint16 array (no plan field is uint16
otherwise) and :func:`_rebuild` gives tagged arrays back as the bits they
are: the upload views them as ``torch.bfloat16``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from ..formats.bell2 import Bell2Plan
from ..formats.sbell import SBellPlan
from ..formats.sdia import SDiaPlan
from ..utils import trace
from ..utils.logging import info

__all__ = ["save_plan", "load_plan", "cache_key", "cached_build",
           "BF16_BITS"]

#: bump to invalidate every cached plan (layout/kernel contract changes);
#: the reference's number, since the files are shared
PLAN_VERSION = 20  # 20: contig-8 baseline restored (depth picked by slab cost)

_PLAN_TYPES = {
    "Bell2Plan": Bell2Plan,
    "SBellPlan": SBellPlan,
    "SDiaPlan": SDiaPlan,
}

#: the numpy type in which a host plan holds bfloat16 values: their bits
BF16_BITS = np.dtype(np.uint16)


def _flatten(plan, prefix, arrays, manifest):
    cls = type(plan).__name__
    if cls not in _PLAN_TYPES:
        raise TypeError(f"cannot serialize {cls}")
    fields = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        key = f"{prefix}{f.name}"
        if isinstance(v, np.ndarray):
            arrays[key] = v
            if v.dtype == BF16_BITS:  # npz has no bf16: the bits, tagged
                fields[f.name] = {"kind": "array", "dtype": "bfloat16"}
            else:
                fields[f.name] = {"kind": "array"}
        elif isinstance(v, (Bell2Plan, SBellPlan, SDiaPlan)):
            fields[f.name] = {"kind": "plan"}
            _flatten(v, key + ".", arrays, manifest)
        elif v is None:
            fields[f.name] = {"kind": "none"}
        elif isinstance(v, tuple):
            fields[f.name] = {"kind": "tuple", "value": list(v)}
        else:
            fields[f.name] = {"kind": "scalar", "value": v}
    manifest[prefix.rstrip(".") or "root"] = {"cls": cls, "fields": fields}


def save_plan(path, plan) -> None:
    """Serialize a plan (Bell2Plan / SBellPlan / SDiaPlan) to .npz."""
    arrays: dict = {}
    manifest: dict = {}
    _flatten(plan, "root.", arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"version": PLAN_VERSION, "nodes": manifest}).encode(),
        dtype=np.uint8,
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _rebuild(prefix, nodes, data):
    node = nodes[prefix.rstrip(".") or "root"]
    cls = _PLAN_TYPES[node["cls"]]
    kwargs = {}
    for name, spec in node["fields"].items():
        key = f"{prefix}{name}"
        if spec["kind"] == "array":
            arr = data[key]
            if spec.get("dtype") == "bfloat16":  # the bits, as the port
                arr = arr.view(BF16_BITS)       # holds bf16 values
            kwargs[name] = arr
        elif spec["kind"] == "plan":
            kwargs[name] = _rebuild(key + ".", nodes, data)
        elif spec["kind"] == "none":
            kwargs[name] = None
        elif spec["kind"] == "tuple":
            kwargs[name] = tuple(spec["value"])
        else:
            kwargs[name] = spec["value"]
    return cls(**kwargs)


def load_plan(path):
    """Load a plan saved by :func:`save_plan` (or by the reference's).

    Raises ``ValueError`` on version mismatch (caller rebuilds)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    m = json.loads(bytes(data.pop("__manifest__")).decode())
    if m["version"] != PLAN_VERSION:
        raise ValueError(
            f"plan version {m['version']} != {PLAN_VERSION}"
        )
    return _rebuild("root.", m["nodes"], data)


def cache_key(csr, dtype, **params) -> str:
    """Content hash of matrix payload + build parameters."""
    h = hashlib.sha256()
    h.update(f"v{PLAN_VERSION};{np.dtype(dtype).name};".encode())
    h.update(json.dumps(params, sort_keys=True).encode())
    h.update(np.int64([csr.nrows, csr.ncols, csr.nnz]).tobytes())
    h.update(np.ascontiguousarray(csr.indptr).tobytes())
    h.update(np.ascontiguousarray(csr.indices).tobytes())
    h.update(np.ascontiguousarray(csr.data).tobytes())
    return h.hexdigest()[:32]


def cached_build(build_fn, csr, dtype, cache_dir, **params):
    """Build via ``build_fn()`` with content-addressed .npz caching.

    ``cache_dir`` empty/None disables caching entirely. The steps are the
    spans ``cfs.tune.key``, ``cfs.tune.plan_load`` (a hit: the counter
    ``plancache.hits``), ``cfs.tune.plan_build`` and
    ``cfs.tune.plan_save`` (a miss: ``plancache.misses``)."""
    if not cache_dir:
        with trace.span("cfs.tune.plan_build"):
            return build_fn()
    os.makedirs(cache_dir, exist_ok=True)
    with trace.span("cfs.tune.key"):
        key = cache_key(csr, dtype, **params)
    path = os.path.join(cache_dir, f"plan-{key}.npz")
    if os.path.exists(path):
        try:
            with trace.span("cfs.tune.plan_load"):
                plan = load_plan(path)
            trace.count("plancache.hits")
            info("plancache: hit %s", path)
            return plan
        except (ValueError, KeyError, OSError) as e:
            info("plancache: discarding %s (%s)", path, e)
    trace.count("plancache.misses")
    with trace.span("cfs.tune.plan_build"):
        plan = build_fn()
    with trace.span("cfs.tune.plan_save"):
        save_plan(path, plan)
    info("plancache: saved %s", path)
    return plan
