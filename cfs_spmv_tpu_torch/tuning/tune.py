"""The tuning dispatcher: CSR → device-ready tuned plan.

Port of ``cfs_spmv_tpu/tuning/tune.py`` for the tuned symmetric fp32
path: triangle split + dense-diagonal peel + far-stream layout
(``formats/sbell.build_sbell_plan``) → device upload
(``ops/spmv.sym_to_device``) → apply-function binding
(``ops/spmv.sbell_apply``), with the optional RCM permutation around it.

Off the slice, and raising ``NotImplementedError``: the general BELL2 path
(``Format.CSR``/``BELL``/``COO`` or ``Tuning.NONE``; ROADMAP A4), BSR
(A5), float64 (A8), ``values="bfloat16"`` (A5) and SpMM (A7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..formats.csr import CSR
from ..formats.sbell import build_sbell_plan
from ..ops import spmv as spmv_ops
from ..utils.config import config
from ..utils.logging import info, warn
from ..utils.platform import Format, Kernel, Tuning

__all__ = ["TunedMatrix", "tune"]


@dataclasses.dataclass
class TunedMatrix:
    """A tuned, device-resident matrix with a bound apply function.

    The analog of a tuned ``CSRMatrix`` with its ``spmv_fn`` pointer bound
    (``csr_matrix.hpp:124``). The applier is a plain function of
    (operands, x), so solvers and timing loops can hold the operands and
    call it directly (``pure_apply``).
    """

    format: Format
    nrows: int
    ncols: int
    nnz_full: int
    symmetric: bool
    plan: object
    operands: object  # device struct (or dict of it + permutations)
    _apply_mv: Callable  # (operands, x) -> y
    spill_fraction: float  # far-stream fraction for symmetric plans
    padding_ratio: float
    device: torch.device
    perm: np.ndarray | None = None  # RCM row order, if applied
    #: un-permuted applier + operands when RCM is applied (the wrapped
    #: matvec pays two 1-D gathers per call — solvers work in permuted
    #: space via pure_apply + encode/decode)
    _inner: tuple | None = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_mv(self.operands, x)

    def matmat(self, x):
        raise NotImplementedError(
            "SpMM (sbell_apply_mm and kernels B7-B11) is not ported yet: "
            "ROADMAP A7"
        )

    def pure_apply(self):
        """(fn, operands) with fn a plain function of its arguments. When
        RCM reordering is active the returned fn works in PERMUTED space:
        feed it ``encode(x)`` and ``decode`` the result (norms are
        permutation-invariant, so solver scalars need no translation)."""
        if self._inner is not None:
            return self._inner
        return self._apply_mv, self.operands

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """User space → internal (permuted) space."""
        if self.perm is None:
            return x
        return torch.index_select(x, 0, self.operands["p"])

    def decode(self, y: torch.Tensor) -> torch.Tensor:
        """Internal (permuted) space → user space."""
        if self.perm is None:
            return y
        return torch.index_select(y, 0, self.operands["ip"])

    def stream_bytes(self) -> int:
        return self.plan.stream_bytes()


def tune(
    csr: CSR,
    *,
    fmt: Format = Format.NONE,
    kernel: Kernel = Kernel.SpDMV,
    tuning: Tuning = Tuning.AGGRESSIVE,
    dtype=np.float32,
    reorder: bool | str = "auto",
    values: str = "same",
    device="cpu",
) -> TunedMatrix:
    """Select a layout and build the tuned matrix on ``device``.

    Format selection mirrors the reference factory
    (``sparse_matrix.tpp:14-24``): ``SSS``/``HYB`` require symmetric
    storage; ``NONE`` auto-picks SSS for symmetric matrices under
    aggressive tuning, else the general path (not ported yet).

    ``reorder``: bandwidth-reducing RCM permutation. ``"auto"`` applies
    it only when it shrinks the mean bandwidth 2x on a scattered square
    matrix; ``True`` forces, ``False`` disables.
    """
    if kernel != Kernel.SpDMV:
        raise NotImplementedError(
            "SpMM (Kernel.SpDMM) is not ported yet: ROADMAP A7"
        )
    device = spmv_ops.as_device(device)
    if fmt == Format.NONE:
        fmt = (
            Format.SSS
            if (csr.symmetric and tuning == Tuning.AGGRESSIVE)
            else Format.CSR
        )
    if fmt == Format.BSR:
        raise NotImplementedError("Format.BSR is not ported yet: ROADMAP A5")
    if fmt in (Format.SSS, Format.HYB) and not csr.symmetric:
        raise ValueError(f"format {fmt} requires a symmetric matrix")
    if np.dtype(dtype) == np.float64:
        raise NotImplementedError(
            "float64 (the double-float kernels B13-B16, as IEEE fp64) is "
            "not ported yet: ROADMAP A8"
        )
    if np.dtype(dtype) != np.float32:
        raise ValueError(f"dtype must be float32, got {np.dtype(dtype)}")
    if values == "bfloat16":
        raise NotImplementedError(
            "values='bfloat16' storage is not ported yet: ROADMAP A5"
        )
    if values != "same":
        raise ValueError(f"values must be 'same' or 'bfloat16', got {values}")
    if not (fmt in (Format.SSS, Format.HYB) and tuning == Tuning.AGGRESSIVE):
        raise NotImplementedError(
            f"the general path (format {fmt}, tuning {tuning}: "
            "build_general_plan + bell2_apply) is not ported yet: ROADMAP A4"
        )

    perm = None
    if reorder and csr.nrows == csr.ncols and csr.nnz:
        from .reorder import choose_reorder

        t0 = time.perf_counter()
        res, _, _ = choose_reorder(
            csr, min_gain=2.0 if reorder == "auto" else 1.0
        )
        info("tune: reorder decision %.1fs", time.perf_counter() - t0)
        if res is not None:
            perm, csr = res

    plan = build_sbell_plan(csr, dtype=dtype)
    dev = spmv_ops.sym_to_device(plan, device)
    tuned = TunedMatrix(
        fmt, csr.nrows, csr.ncols, plan.nnz_full, True, plan,
        dev, spmv_ops.sbell_apply, plan.far_fraction, plan.padding_ratio,
        device,
    )
    if perm is not None:
        tuned = _permuted(tuned, perm)
    if tuned.spill_fraction > config.spill_warn_fraction:
        warn(
            "tune: %.0f%% of nonzeros fell to the one-sided far stream "
            "(scattered structure; consider reorder=True)",
            100 * tuned.spill_fraction,
        )
    info(
        "tune: fmt=%s nnz=%d pad=%.2fx far=%.4f reorder=%s device=%s",
        tuned.format, tuned.nnz_full, tuned.padding_ratio,
        tuned.spill_fraction, perm is not None, device,
    )
    return tuned


def _permuted(tuned: TunedMatrix, perm: np.ndarray) -> TunedMatrix:
    """Wrap the applier with the P A Pᵀ input/output gathers; the
    permutation tensors travel inside the operands."""
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    operands = {
        "dev": tuned.operands,
        "p": torch.as_tensor(perm, dtype=torch.int64, device=tuned.device),
        "ip": torch.as_tensor(iperm, dtype=torch.int64, device=tuned.device),
    }
    inner_mv = tuned._apply_mv

    def apply_mv(ops, x):
        y = inner_mv(ops["dev"], torch.index_select(x, 0, ops["p"]))
        return torch.index_select(y, 0, ops["ip"])

    return dataclasses.replace(
        tuned, operands=operands, _apply_mv=apply_mv, perm=perm,
        _inner=(inner_mv, tuned.operands),
    )
