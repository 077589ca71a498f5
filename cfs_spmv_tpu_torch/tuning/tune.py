"""The tuning dispatcher: CSR → device-ready tuned plan.

Port of ``cfs_spmv_tpu/tuning/tune.py`` for fp32: the tuned symmetric
path (``Format.SSS``/``HYB`` under ``Tuning.AGGRESSIVE``: triangle split
+ dense-diagonal peel + paired/far layout, ``formats/sbell``, bound to
``ops/spmv.sbell_apply``) and the general path (``Format.CSR``/``BELL``/
``COO``, or ``Tuning.NONE``: symmetric input expanded, signed-offset
diagonal peel under aggressive tuning, ``formats/bell2.build_general_plan``,
bound to ``ops/spmv.bell2_apply``), with the optional RCM permutation
around either. Each path binds its SpMM applier beside it
(``sbell_apply_mm``, ``bell2_apply_mm``): one plan serves both.
``Format.BSR`` keeps its host block container and runs one of the two.

Off the slice, and raising ``NotImplementedError``: float64 (ROADMAP
A8) and ``values="bfloat16"`` (A5).
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
    """A tuned, device-resident matrix with bound apply functions.

    The analog of a tuned ``CSRMatrix`` with its ``spmv_fn`` pointer bound
    (``csr_matrix.hpp:124``). The appliers are plain functions of
    (operands, x) and (operands, X), so solvers and timing loops can hold
    the operands and call them directly (``pure_apply``,
    ``pure_apply_mm``).
    """

    format: Format
    nrows: int
    ncols: int
    nnz_full: int
    symmetric: bool
    plan: object
    operands: object  # device struct (or dict of it + permutations)
    _apply_mv: Callable  # (operands, x) -> y
    _apply_mm: Callable  # (operands, X) -> Y, X (ncols, B)
    spill_fraction: float  # far-stream fraction for symmetric plans
    padding_ratio: float
    device: torch.device
    perm: np.ndarray | None = None  # RCM row order, if applied
    bsr: object | None = None  # BSR host container when fmt=BSR
    #: un-permuted appliers (mv, mm) + operands when RCM is applied (the
    #: wrapped appliers pay two row gathers per call — solvers work in
    #: permuted space via pure_apply + encode/decode)
    _inner: tuple | None = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_mv(self.operands, x)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_mm(self.operands, x)

    def pure_apply(self):
        """(fn, operands) with fn a plain function of its arguments. When
        RCM reordering is active the returned fn works in PERMUTED space:
        feed it ``encode(x)`` and ``decode`` the result (norms are
        permutation-invariant, so solver scalars need no translation)."""
        if self._inner is not None:
            mv, _, ops = self._inner
            return mv, ops
        return self._apply_mv, self.operands

    def pure_apply_mm(self):
        """:meth:`pure_apply` for the SpMM applier (rows of X permute
        like x)."""
        if self._inner is not None:
            _, mm, ops = self._inner
            return mm, ops
        return self._apply_mm, self.operands

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """User space → internal (permuted) space (rows of a 2-D X too)."""
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
    aggressive tuning, else the general BELL2 path. ``Tuning.NONE`` on a
    symmetric matrix expands it and runs the one-sided stream (the
    untuned-oracle path of the reference's differential tests,
    ``test_spmv_mmf.cpp:85-89``).

    ``reorder``: bandwidth-reducing RCM permutation, under aggressive
    tuning of a square matrix. ``"auto"`` applies it only when it shrinks
    the mean bandwidth 2x on a scattered matrix; ``True`` forces,
    ``False`` disables.

    ``kernel`` does not change the plan: both appliers are bound.
    """
    del kernel
    device = spmv_ops.as_device(device)
    if fmt == Format.NONE:
        fmt = (
            Format.SSS
            if (csr.symmetric and tuning == Tuning.AGGRESSIVE)
            else Format.CSR
        )
    bsr = None
    if fmt == Format.BSR:
        # BSR is a host-format contract (block detection + 1/b² index
        # storage, formats/bsr.py); the tuned execution path is shared
        from ..formats.bsr import BSR, detect_block_size

        bsr = BSR.from_csr(csr, detect_block_size(csr))
        fmt = Format.SSS if csr.symmetric else Format.CSR
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
    perm = None
    if (reorder and tuning == Tuning.AGGRESSIVE and csr.nrows == csr.ncols
            and csr.nnz):
        from .reorder import choose_reorder

        t0 = time.perf_counter()
        res, _, _ = choose_reorder(
            csr, min_gain=2.0 if reorder == "auto" else 1.0
        )
        info("tune: reorder decision %.1fs", time.perf_counter() - t0)
        if res is not None:
            perm, csr = res

    if fmt in (Format.SSS, Format.HYB) and tuning == Tuning.AGGRESSIVE:
        plan = build_sbell_plan(csr, dtype=dtype)
        dev = spmv_ops.sym_to_device(plan, device)
        tuned = TunedMatrix(
            fmt, csr.nrows, csr.ncols, plan.nnz_full, True, plan,
            dev, spmv_ops.sbell_apply, spmv_ops.sbell_apply_mm,
            plan.far_fraction, plan.padding_ratio, device,
        )
    else:
        from ..formats.bell2 import build_general_plan

        gen_csr = (CSR.from_coo(csr.to_coo().expand_symmetric())
                   if csr.symmetric else csr)
        # aggressive tuning peels dense signed-offset diagonals into the
        # index-free SDIA stream; Tuning.NONE stays the plain one-sided
        # oracle path
        plan = build_general_plan(gen_csr, dtype=dtype,
                                  dia=tuning == Tuning.AGGRESSIVE)
        dev = spmv_ops.to_device(plan, device)
        tuned = TunedMatrix(
            Format.CSR, gen_csr.nrows, gen_csr.ncols, gen_csr.nnz,
            csr.symmetric, plan, dev, spmv_ops.bell2_apply,
            spmv_ops.bell2_apply_mm, 0.0,
            plan.padding_ratio, device,
        )
    if perm is not None:
        tuned = _permuted(tuned, perm)
    if bsr is not None:
        tuned = dataclasses.replace(tuned, format=Format.BSR, bsr=bsr)
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
    """Wrap the appliers with the P A Pᵀ input/output gathers (rows of x
    or X); the permutation tensors travel inside the operands."""
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    operands = {
        "dev": tuned.operands,
        "p": torch.as_tensor(perm, dtype=torch.int64, device=tuned.device),
        "ip": torch.as_tensor(iperm, dtype=torch.int64, device=tuned.device),
    }
    inner_mv, inner_mm = tuned._apply_mv, tuned._apply_mm

    def apply_mv(ops, x):
        y = inner_mv(ops["dev"], torch.index_select(x, 0, ops["p"]))
        return torch.index_select(y, 0, ops["ip"])

    def apply_mm(ops, x):
        y = inner_mm(ops["dev"], torch.index_select(x, 0, ops["p"]))
        return torch.index_select(y, 0, ops["ip"])

    return dataclasses.replace(
        tuned, operands=operands, _apply_mv=apply_mv, _apply_mm=apply_mm,
        perm=perm, _inner=(inner_mv, inner_mm, tuned.operands),
    )
