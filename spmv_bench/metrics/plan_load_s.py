"""plan_load_s: host seconds of loading the plan from the plan cache in
set-up, by the port's span ``cfs.tune.plan_load``; nothing where the
cache missed and the plan was built."""

from spmv_bench import trace


def read(run):
    return trace.span_s(run.setup_record, "cfs.tune.plan_load")
