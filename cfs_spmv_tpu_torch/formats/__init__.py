from .bell2 import Bell2Plan, build_bell2_plan  # noqa: F401
from .coo import COO  # noqa: F401
from .csr import CSR  # noqa: F401
from .sbell import SBellPlan, build_sbell_plan  # noqa: F401
