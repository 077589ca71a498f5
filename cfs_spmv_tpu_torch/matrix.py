"""SparseMatrix facade + factory.

Port of ``cfs_spmv_tpu/matrix.py``: the public matrix API mirroring the
reference's abstract base + factory (``sparse_matrix.hpp:23-41``,
``sparse_matrix.tpp:14-24``): create from an MMF file / COO / CSR /
scipy matrix, query shape/nnz/symmetry/size, ``tune()`` onto a device,
and ``dense_vector_multiply``, which returns a fresh tensor instead of
writing into ``y``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .formats.coo import COO
from .formats.csr import CSR
from .io.mmf import read_mmf
from .tuning.tune import TunedMatrix, tune
from .utils import trace
from .utils.platform import Format, Kernel, Tuning

__all__ = ["SparseMatrix"]


class SparseMatrix:
    """A sparse matrix with optional tuned device state.

    Factory semantics follow the reference (``sparse_matrix.tpp:14-24``):
    ``Format.SSS`` → symmetric storage; ``Format.HYB`` → symmetric +
    hybrid split (implied by the far stream); anything else → general CSR
    storage.
    """

    def __init__(self, csr: CSR, fmt: Format = Format.CSR):
        self._csr = csr
        self._fmt = fmt
        self._tuned: TunedMatrix | None = None

    # --- factory -------------------------------------------------------
    @staticmethod
    def create(source, fmt: Format = Format.CSR, *, dtype=None) -> "SparseMatrix":
        """Create from an ``.mtx`` path, a COO, a CSR or a scipy matrix.

        Analog of ``SparseMatrix::create()`` (``sparse_matrix.hpp:38-40``).
        """
        want_sym = fmt in (Format.SSS, Format.HYB)
        if isinstance(source, (str, os.PathLike)):
            hdr, row, col, val = read_mmf(
                source, dtype=dtype or np.float64,
                expand_symmetric=hdr_expand_choice(want_sym),
            )
            if want_sym and not hdr.symmetric:
                raise ValueError(
                    f"{fmt} requested but file is not symmetric"
                )
            coo = COO(
                hdr.nrows, hdr.ncols, row, col, val,
                symmetric=hdr.symmetric and want_sym,
            )
            csr = CSR.from_coo(coo if want_sym else coo.expand_symmetric()
                               if hdr.symmetric else coo)
        elif isinstance(source, COO):
            coo = source if want_sym == source.symmetric else (
                source.expand_symmetric() if not want_sym else source
            )
            if want_sym and not coo.symmetric:
                raise ValueError(f"{fmt} requires symmetric COO storage")
            csr = CSR.from_coo(coo)
        elif isinstance(source, CSR):
            csr = source
        elif type(source).__module__.startswith("scipy.sparse"):
            csr = CSR.from_scipy(source, symmetric=want_sym)
        else:
            raise TypeError(f"cannot create SparseMatrix from {type(source)}")
        if dtype is not None:
            csr = CSR(csr.nrows, csr.ncols, csr.indptr, csr.indices,
                      csr.data.astype(dtype), csr.symmetric)
        return SparseMatrix(csr, fmt)

    # --- introspection (ref sparse_matrix.hpp:27-35) -------------------
    @property
    def nrows(self) -> int:
        return self._csr.nrows

    @property
    def ncols(self) -> int:
        return self._csr.ncols

    @property
    def nnz(self) -> int:
        """Stored nonzeros (lower triangle only for symmetric storage)."""
        return self._csr.nnz

    @property
    def nnz_full(self) -> int:
        """Logical nonzeros (both triangles for symmetric storage);
        cached — the COO materialization behind it is O(nnz)."""
        if getattr(self, "_nnz_full", None) is None:
            self._nnz_full = self._csr.to_coo().nnz_full
        return self._nnz_full

    @property
    def symmetric(self) -> bool:
        return self._csr.symmetric

    @property
    def csr(self) -> CSR:
        return self._csr

    def diagonal(self) -> np.ndarray:
        """Main diagonal as a dense vector (e.g. the Jacobi
        preconditioner of a conjugate-gradient solve)."""
        if self._csr.symmetric:
            _, diag, _ = self._csr.split_triangle()
            return diag
        n = min(self.nrows, self.ncols)
        diag = np.zeros(n, self._csr.data.dtype)
        indptr, indices, data = (
            self._csr.indptr, self._csr.indices, self._csr.data,
        )
        rowlen = np.diff(indptr[: n + 1])
        rows = np.repeat(np.arange(n, dtype=np.int64), rowlen)
        mask = indices[: indptr[n]] == rows
        diag[rows[mask]] = data[: indptr[n]][mask]
        return diag

    @property
    def tuned(self) -> TunedMatrix | None:
        return self._tuned

    def size(self) -> int:
        """Memory footprint in bytes (ref ``csr_matrix.tpp:190-228``):
        tuned stream size if tuned, else host CSR size."""
        if self._tuned is not None:
            return self._tuned.stream_bytes()
        return self._csr.size_bytes()

    # --- tuning + execution -------------------------------------------
    def tune(
        self,
        kernel: Kernel = Kernel.SpDMV,
        tuning: Tuning = Tuning.AGGRESSIVE,
        *,
        dtype=np.float32,
        device="cuda",
        **kwargs,
    ) -> "SparseMatrix":
        """Preprocess into the tuned layout on ``device``: the card by
        default, which raises ``RuntimeError`` where CUDA is absent
        (ref ``CSRMatrix::tune``, ``csr_matrix.tpp:230-310``). Extra
        kwargs (``reorder``, ``values``, ``cache_dir``) pass through to
        :func:`cfs_spmv_tpu_torch.tuning.tune.tune`."""
        self._tuned = tune(
            self._csr, fmt=self._fmt, kernel=kernel, tuning=tuning,
            dtype=dtype, device=device, **kwargs,
        )
        self._tune_sig = tune_signature(tuning, dtype, device, **kwargs)
        self._spdmv_sig = None  # direct tune() is authoritative
        return self

    def dense_vector_multiply(self, x):
        """y = A @ x (ref ``sparse_matrix.hpp:36``). Tunes with the
        untuned-oracle defaults on first use if untuned: ``Tuning.NONE``,
        the general one-sided path (a symmetric matrix is expanded), on
        x's device when x is a tensor and on the card otherwise, in
        float64 for a float64 x (a numpy array or a tensor) and in
        float32 for any other x."""
        if self._tuned is None:
            if isinstance(x, torch.Tensor):
                device, f64 = x.device, x.dtype == torch.float64
            else:
                device, f64 = "cuda", np.asarray(x).dtype == np.float64
            self.tune(tuning=Tuning.NONE, device=device,
                      dtype=np.float64 if f64 else np.float32)
        tuned = self._tuned
        with trace.span("cfs.apply", dtype=tuned.dtype) as s:
            x = torch.as_tensor(x, dtype=tuned.dtype, device=tuned.device)
            s.set(rhs=1 if x.ndim == 1 else x.shape[1])
            return tuned.apply(x)

    __matmul__ = dense_vector_multiply


def tune_signature(tuning, dtype, device, **kwargs) -> tuple:
    """Result-affecting tune configuration, normalized with defaults.

    ``SpDMV`` retunes an already-tuned matrix when this differs from the
    stored signature (a plan tuned onto another device or with other
    options must not be reused silently). ``cache_dir`` is left out, as in
    the reference: it changes no result."""
    return (
        tuning,
        np.dtype(dtype).name,
        str(torch.device(device)),
        kwargs.get("values", "same"),
        kwargs.get("reorder", "auto"),
    )


def hdr_expand_choice(want_sym: bool) -> bool:
    """Symmetric files: keep the triangle for symmetric formats, expand
    for general ones (load-time expansion analog, ``mmf.hpp:279-293``)."""
    return not want_sym
