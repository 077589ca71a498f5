"""device_idle_pct.cg: the share of the traced window of whole solves in
which no operation ran on the card."""


def read(run):
    if run.kind != "cg" or run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
