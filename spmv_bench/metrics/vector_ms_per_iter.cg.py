"""vector_ms_per_iter.cg: device milliseconds of every other operation
replayed from the solver's CUDA graphs in the traced window (the solver's
vector passes and the composition's copies), per CG iteration replayed."""


def read(run):
    tr = run.trace
    if run.kind != "cg" or tr is None or not tr.replayed:
        return None
    return (tr.device_s(graph=True, port=False) * 1e3
            / (run.traced * run.iters))
