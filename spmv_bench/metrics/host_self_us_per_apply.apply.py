"""host_self_us_per_apply.apply: host microseconds of an apply's own
Python in the traced window, by the port's spans: each ``cfs.apply``
less the union of its ``cfs.stage`` (the composition's staging) and
``cfs.launch`` (the native calls) spans, mean over the window's
applies."""

from spmv_bench import trace

INNER = ("cfs.stage", "cfs.launch")


def read(run):
    rec = run.window_record
    if run.kind != "apply" or rec is None:
        return None
    applies = [s for s in rec.spans
               if s.name == "cfs.apply" and s.parent is None]
    if not applies:
        return None
    inner = {}
    for s in rec.spans:
        if s.name in INNER:
            inner.setdefault(s.root, []).append(s)
    own = sum(trace.self_s(a, inner.get(a.id, [])) for a in applies)
    return own / len(applies) * 1e6
