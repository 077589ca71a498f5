"""solve_overhead_ms.cg: a solve's host wall less its replay loop's time
by the solver's own CUDA events (``models/solvers._iterate.loop``), mean
over the window's solves: the set-up passes, the warm-up step and the
capture."""


def read(run):
    if run.kind != "cg" or not run.loop_s:
        return None
    gaps = [w - s for w, s in zip(run.solve_walls_s, run.loop_s)]
    return sum(gaps) / len(gaps) * 1e3
