"""plan_key_s: host seconds of the plan cache's key in set-up, by the
port's span ``cfs.tune.key``: the content hash of the matrix and the
build parameters."""

from spmv_bench import trace


def read(run):
    return trace.span_s(run.setup_record, "cfs.tune.key")
