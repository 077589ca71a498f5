"""SpDMV kernel functor — the user-facing kernel API.

Port of ``cfs_spmv_tpu/models/spdmv.py``: the analog of the reference's
``SpDMV`` functor (``include/kernel/sparse_kernel.hpp:17-27``,
``.tpp:8-27``): construction runs preprocessing (``tune()``) onto an
explicit device, and the call operator checks dimensions and dispatches
to the bound kernel path, returning y instead of writing into a caller
buffer. SpDMM (a 2-D x) is not ported yet (ROADMAP A7) and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..matrix import SparseMatrix, tune_signature
from ..utils.platform import Kernel, Tuning

__all__ = ["SpDMV"]


class SpDMV:
    """y = A @ x with tuned preprocessing at construction
    (ref ``sparse_kernel.tpp:8-18``)."""

    kernel = Kernel.SpDMV

    def __init__(
        self,
        A: SparseMatrix,
        tuning: Tuning = Tuning.AGGRESSIVE,
        *,
        dtype=np.float32,
        device="cpu",
        **kwargs,
    ):
        self.A = A
        sig = tune_signature(tuning, dtype, device, **kwargs)
        stored = getattr(A, "_tune_sig", None)
        # retune when: untuned; the plan's dtype or device differs; or a
        # PREVIOUS SpDMV tuned with a different configuration. An
        # explicit user A.tune(...) with non-default kwargs is
        # authoritative and is NOT silently re-run over preference
        # fields (reorder/values/tuning).
        if (
            A.tuned is None
            or (stored is not None and stored[1:3] != sig[1:3])
            or (getattr(A, "_spdmv_sig", None) is not None
                and A._spdmv_sig != sig)
        ):
            A.tune(self.kernel, tuning, dtype=dtype, device=device, **kwargs)
        A._spdmv_sig = sig

    def __call__(self, x):
        """Dimension-checked apply (ref ``sparse_kernel.tpp:20-27``).
        ``x`` (a tensor or array) is moved to the matrix's device as
        float32, the plan's value type."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self.A.tuned.device)
        if x.shape[0] != self.A.ncols:
            raise ValueError(
                f"x has {x.shape[0]} rows, matrix has {self.A.ncols} cols"
            )
        if x.ndim != 1:
            return self.A.tuned.matmat(x)
        return self.A.tuned.matvec(x)
