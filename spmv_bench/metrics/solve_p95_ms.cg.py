"""solve_p95_ms.cg: the 95th percentile over the window's solves of one
solve's host wall, from the call to ``cg`` to its x synchronised."""

import numpy as np


def read(run):
    if run.kind != "cg" or not run.solve_walls_s:
        return None
    return float(np.percentile(run.solve_walls_s, 95)) * 1e3
