"""spmv_roofline: the apply's share of its roofline: the least time the
cell's cards could take for the canonical bytes and operations of one
apply (``counts.bound_s`` against one card's peaks times the cards; the
bytes bound it), over the device time of all of an apply's launches
(kernels, fills, copies) in the traced window on the card that ran the
most."""

from spmv_bench import counts


def read(run):
    if run.kind != "apply" or run.trace is None or run.peak is None:
        return None
    device_s = run.trace.busiest_card_s() / run.traced
    if device_s <= 0:
        return None
    flops = counts.apply_flops(run.logical_nnz, run.rhs)
    return 100 * counts.bound_s(run.apply_bytes, flops, run.peak,
                                run.precision) / run.chips / device_s
