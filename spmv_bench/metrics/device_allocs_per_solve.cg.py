"""device_allocs_per_solve.cg: the caching allocator's device
allocations (``cudaMalloc``) in the traced window, by the port's counter
``cuda.device_allocs``, per ``cfs.solve``."""


def read(run):
    rec = run.window_record
    if run.kind != "cg" or rec is None:
        return None
    solves = sum(s.name == "cfs.solve" for s in rec.spans)
    if not solves or "cuda.device_allocs" not in rec.counters:
        return None
    return rec.counters["cuda.device_allocs"] / solves
