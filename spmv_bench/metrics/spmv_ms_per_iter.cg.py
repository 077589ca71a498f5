"""spmv_ms_per_iter.cg: device milliseconds of the port's own kernels
replayed from the solver's CUDA graphs in the traced window, per CG
iteration replayed."""


def read(run):
    tr = run.trace
    if run.kind != "cg" or tr is None or not tr.replayed:
        return None
    return tr.device_s(graph=True, port=True) * 1e3 / (run.traced * run.iters)
