"""reorder_s: host seconds of the port's bandwidth-reducing reordering in
set-up (the RCM permutation and its judgement), by the port's span
``cfs.plan.reorder``, which runs before the plan cache's lookup; None
where it did not run."""

from spmv_bench import trace


def read(run):
    return trace.span_s(run.setup_record, "cfs.plan.reorder")
