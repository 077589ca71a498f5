"""device_idle_pct.apply: the share of the traced window in which no
operation ran on the card (1 - the union of its busy intervals over the
window's wall)."""


def read(run):
    if run.kind != "apply" or run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
