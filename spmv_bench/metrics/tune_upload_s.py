"""tune_upload_s: host seconds of the ``SpDMV(...)`` construction, the
card synchronised: the plan cache's lookup or the planning, and the
upload."""


def read(run):
    return run.tune_upload_s
