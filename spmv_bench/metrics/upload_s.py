"""upload_s: host seconds of the tuned operands' upload to the card in
set-up, by the port's spans ``cfs.tune.upload``, which end once the
copies have finished."""

from spmv_bench import trace


def read(run):
    return trace.span_s(run.setup_record, "cfs.tune.upload")
