"""solve_prep_ms.cg: host milliseconds of a solve's preparation in the
traced window, by the port's spans: the union of a ``cfs.solve``'s
``setup``, ``warmup``, ``capture`` and ``restore`` steps
(``trace.SOLVE_PREP``), mean over the window's solves."""

from spmv_bench import trace


def read(run):
    rec = run.window_record
    if run.kind != "cg" or rec is None:
        return None
    solves = [s for s in rec.spans
              if s.name == "cfs.solve" and s.parent is None]
    if not solves:
        return None
    prep = {}
    for s in rec.spans:
        if s.name in trace.SOLVE_PREP:
            prep.setdefault(s.root, []).append(s)
    covered = sum((s.t1 - s.t0) / 1e9 - trace.self_s(s, prep.get(s.id, []))
                  for s in solves)
    return covered / len(solves) * 1e3
