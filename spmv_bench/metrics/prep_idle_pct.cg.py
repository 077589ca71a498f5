"""prep_idle_pct.cg: the share of the traced window of whole solves in
which no card is busy while a solve's preparation runs on the host (the
idle time under the port's annotations of ``trace.SOLVE_PREP``)."""

from spmv_bench import trace


def read(run):
    tr = run.trace
    if run.kind != "cg" or tr is None or run.window_record is None:
        return None
    idle = tr.idle_by_span(trace.SOLVE_PREP)
    if idle is None:
        return None
    return 100 * sum(v for k, v in idle.items() if k is not None) \
        / tr.window_s
