"""launches_per_apply.apply: the device's operations (kernels, fills,
copies) in the traced window, per apply."""


def read(run):
    if run.kind != "apply" or run.trace is None:
        return None
    return run.trace.launches() / run.traced
