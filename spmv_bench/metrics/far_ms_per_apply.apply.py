"""far_ms_per_apply.apply: device milliseconds an apply of the kernels of
the symmetric float32 plan's far stream (the degree-grouped stream, its
unpermute, the sparse residual's entries, and the one-sided stream's
kernel), from the traced window's device events over its applies. None
where no such kernel ran."""

#: the far stream's kernels, by the start of their names
FAR = ("bell2_walks_kernel", "unperm_gather_kernel", "bell2_entries_kernel",
       "bell2_spmv_kernel")


def read(run):
    tr = run.trace
    if run.kind != "apply" or tr is None or not run.traced:
        return None
    far = [e["dur"] for e in tr.device if e["name"].startswith(FAR)]
    if not far:
        return None
    return sum(far) / 1e3 / run.traced
