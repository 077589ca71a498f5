from .solvers import cg, power_iteration  # noqa: F401
from .spdmv import SpDMM, SpDMV  # noqa: F401
