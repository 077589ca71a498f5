"""far_nnz_share: the share (%) of the matrix's nonzeros (both triangles)
that the port's float32 symmetric plan put in its far stream, by the
port's counters ``tune.fp32_far_nnz`` over ``tune.fp32_nnz`` in set-up,
counted whether the plan was built or loaded. None where the counters are
absent: another plan, or a program without them."""


def read(run):
    rec = run.setup_record
    if rec is None:
        return None
    nnz = rec.counters.get("tune.fp32_nnz")
    far = rec.counters.get("tune.fp32_far_nnz")
    if not nnz or far is None:
        return None
    return 100.0 * far / nnz
