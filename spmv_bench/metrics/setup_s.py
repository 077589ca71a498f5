"""setup_s: seconds from the process's start to the window's first call
(imports, the kernels' build or load, the matrix, tune with the plan
cache, upload, the inputs, warm-up)."""


def read(run):
    return run.setup_s
