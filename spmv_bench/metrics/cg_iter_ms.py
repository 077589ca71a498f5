"""cg_iter_ms: the window's milliseconds over every CG iteration of every
solve completed in it; all that a solve costs counts."""


def read(run):
    if run.kind != "cg":
        return None
    return run.window_s * 1e3 / (run.done * run.iters)
