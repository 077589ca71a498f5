"""fp64_stream_share: the share (%) of the matrix's nonzeros (both
triangles) that the port's float64 plan put in its one-sided stream (the
peel's residual, or the whole matrix where nothing was peeled), by the
port's counters ``tune.fp64_stream_nnz`` over ``tune.fp64_nnz`` in set-up,
counted whether the plan was built or loaded. None where the counters are
absent: a float32 plan, or a program without them."""


def read(run):
    rec = run.setup_record
    if rec is None:
        return None
    nnz = rec.counters.get("tune.fp64_nnz")
    stream = rec.counters.get("tune.fp64_stream_nnz")
    if not nnz or stream is None:
        return None
    return 100.0 * stream / nnz
