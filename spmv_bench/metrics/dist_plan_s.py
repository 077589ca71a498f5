"""dist_plan_s: host seconds of ``DistSpDMV``'s planning in set-up, by the
port's span ``cfs.dist.plan``: the partition, the shard split and every
shard's plans (``DistSpDMV`` keeps no plan cache, so every run pays it)."""

from spmv_bench import trace


def read(run):
    return trace.span_s(run.setup_record, "cfs.dist.plan")
