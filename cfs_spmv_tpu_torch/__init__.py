"""cfs_spmv_tpu_torch — the PyTorch + CUDA port of ``cfs_spmv_tpu``.

The tuned symmetric fp32 SpMV path of the JAX/Pallas package, on PyTorch
tensors with hand-written Hopper (sm_90a) kernels for the Pallas kernels
that path reaches (``ops/``, sources in ``csrc/spmv_kernels.cu``). The
host planners (``formats/``, ``native/``, ``tuning/reorder.py``,
``io/mmf.py``, ``utils/``) are copies of the reference's, held
byte-identical to it by ``tests/test_torch_formats.py``.

Usage::

    A = SparseMatrix.create(csr_or_coo_or_path, Format.SSS)
    y = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32, device="cuda")(x)

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
from .models.spdmv import SpDMV  # noqa: E402
from .utils.platform import Format, Tuning  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "SparseMatrix",
    "SpDMV",
    "Format",
    "Tuning",
    "__version__",
]
