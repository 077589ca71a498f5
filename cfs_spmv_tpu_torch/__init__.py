"""cfs_spmv_tpu_torch — the PyTorch + CUDA port of ``cfs_spmv_tpu``.

The SpMV and SpMM paths of the JAX/Pallas package — the tuned symmetric
path with its paired stream and the general path in float32, and the
float64 route in native IEEE double — on PyTorch tensors with
hand-written Hopper (sm_90a) kernels for the Pallas kernels those paths
reach (``ops/``, sources in ``csrc/spmv_kernels.cu``). The host
planners (``formats/``, ``native/``, ``tuning/reorder.py``,
``io/mmf.py``, ``utils/``) are copies of the reference's, held
byte-identical to it by ``tests/test_torch_formats.py``.

Usage::

    A = SparseMatrix.create(csr_or_coo_or_path, Format.SSS)  # or CSR
    y = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32)(x)
    Y = SpDMM(A, Tuning.AGGRESSIVE, dtype=np.float32)(X)

``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the kernels'
plain PyTorch twins.

Nothing here imports JAX, and nothing CUDA-specific runs at import time:
the kernels are built by nvcc on their first launch.
"""

import os as _os

# NumPy's transparent-hugepage madvise makes big fresh allocations stall
# in synchronous kernel compaction on hosts with THP defrag=madvise;
# preprocessing is allocation-heavy, so opt out unless the user opted
# in. Effective only if numpy is not yet imported.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

from .formats.coo import COO  # noqa: E402
from .formats.csr import CSR  # noqa: E402
from .matrix import SparseMatrix  # noqa: E402
from .models.spdmv import SpDMM, SpDMV  # noqa: E402
from .utils.platform import (  # noqa: E402
    Format,
    Kernel,
    Platform,
    Tuning,
    is_equal,
)

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "SparseMatrix",
    "SpDMV",
    "SpDMM",
    "Format",
    "Kernel",
    "Platform",
    "Tuning",
    "is_equal",
    "__version__",
]
