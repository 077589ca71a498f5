"""apply_gflop_s: the operations of the applies completed in the window
(``counts.apply_flops``: 2 x logical nonzeros x right-hand sides each),
over the window's seconds (which end in the card's synchronisation)."""

from spmv_bench import counts


def read(run):
    if run.kind != "apply":
        return None
    flops = counts.apply_flops(run.logical_nnz, run.rhs)
    return flops * run.done / run.window_s / 1e9
