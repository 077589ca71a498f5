"""host_us_per_apply.apply: host microseconds spent inside each call of
the measured window (no synchronisation in it), total over calls."""


def read(run):
    if run.kind != "apply" or not run.done:
        return None
    return run.host_call_s / run.done * 1e6
