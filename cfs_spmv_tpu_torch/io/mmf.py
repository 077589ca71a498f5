"""MatrixMarket (MMF) I/O.

Host copy of ``cfs_spmv_tpu/io/mmf.py``: the replacement for the
reference's MMF loader
(``include/io/mmf.hpp`` + ``src/mmf.cpp``), keeping its semantics:

- coordinate-format parsing with header/size validation
  (``mmf.hpp:202-272``);
- symmetric files may be expanded to both triangles (``mmf.hpp:279-293``)
  or kept lower-triangular (we keep the triangle by default because the
  symmetric format stores only the lower triangle, matching
  ``csr_matrix.tpp:641-1716``);
- entries sorted by (row, col) (``mmf.hpp:305``);
- 1-based (standard) and 0-based coordinate variants
  (``mmf.hpp:239-250``);
- pattern files (no value column) receive the reference's default value
  0.42 (``mmf.hpp:334-337``).

Unlike the reference's line-at-a-time ``DoRead`` tokenizer
(``src/mmf.cpp:6-44``), parsing is vectorized: the whole body is tokenized
in one pass (optionally by the native C++ parser in ``native/``), which is
the host-side analog of keeping the device fed with large batched work.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os

import numpy as np

from .. import native as _native
from ..utils.logging import info

__all__ = ["MMFHeader", "read_mmf", "write_mmf", "PATTERN_DEFAULT_VALUE"]

#: value assigned to pattern (no-value) entries, ref ``mmf.hpp:334-337``
PATTERN_DEFAULT_VALUE = 0.42


@dataclasses.dataclass
class MMFHeader:
    nrows: int
    ncols: int
    nnz_declared: int
    symmetric: bool
    field: str  # real | integer | pattern
    zero_based: bool
    col_wise: bool = False


def _parse_header(first: str) -> tuple[bool, str, bool, bool]:
    toks = first.strip().split()
    if len(toks) < 5 or toks[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise ValueError(f"not a MatrixMarket file: header {first!r}")
    obj, fmt, field, sym = toks[1].lower(), toks[2].lower(), toks[3].lower(), toks[4].lower()
    if obj != "matrix" or fmt != "coordinate":
        raise ValueError(f"only coordinate matrices supported, got {obj}/{fmt}")
    if field not in ("real", "integer", "pattern", "double"):
        raise ValueError(f"unsupported field type {field!r}")
    if sym not in ("general", "symmetric"):
        raise ValueError(f"unsupported symmetry {sym!r}")
    # variant tokens after the symmetry word (ref mmf.hpp:239-250):
    # base-0/base-1 select the index base; column/row declare the file's
    # entry order (the reference loads-and-sorts column-wise files; we
    # always sort, so the token only needs recognizing). "0-base" is kept
    # as a legacy alias of base-0.
    zero_based = False
    col_wise = False
    for t in toks[5:]:
        tl = t.lower()
        if tl in ("base-0", "0-base"):
            zero_based = True
        elif tl == "base-1":
            zero_based = False
        elif tl == "column":
            col_wise = True
        elif tl == "row":
            col_wise = False
    return sym == "symmetric", field, zero_based, col_wise


def read_mmf(
    path_or_file,
    dtype=np.float64,
    *,
    expand_symmetric: bool = False,
    index_dtype=np.int32,
):
    """Parse an ``.mtx`` file.

    Returns ``(header, row, col, val)`` with 0-based, (row, col)-sorted
    coordinate arrays. For symmetric files the arrays hold only the stored
    triangle (canonicalized to lower) unless ``expand_symmetric`` is set,
    which mirrors the reference's load-time expansion
    (``mmf.hpp:279-293``).
    """
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
    try:
        data = f.read()
    finally:
        if close:
            f.close()
    if isinstance(data, bytes):
        text = data.decode("utf-8", errors="replace")
    else:
        text = data

    # header line
    nl = text.find("\n")
    symmetric, field, zero_based, col_wise = _parse_header(text[:nl])

    # skip comment lines, find size line
    pos = nl + 1
    while pos < len(text) and text[pos] == "%":
        pos = text.find("\n", pos) + 1
    size_end = text.find("\n", pos)
    size_toks = text[pos:size_end].split()
    if len(size_toks) != 3:
        raise ValueError(f"bad size line: {text[pos:size_end]!r}")
    nrows, ncols, nnz_decl = (int(t) for t in size_toks)

    width = 2 if field == "pattern" else 3
    # offsets are into the decoded text, so re-encode the body (ASCII
    # memcpy) rather than slicing the raw bytes, which may differ in
    # length when comments contain undecodable bytes
    parsed = _native.parse_mmf_body(
        text[size_end + 1 :].encode("utf-8", errors="replace"),
        nnz_decl, width,
    )
    if parsed is not None:
        row, col, fval = parsed
    else:
        body = text[size_end + 1 :]
        if "%" in body:
            # comments run from '%' to end of line — both whole-line and
            # trailing inline forms are legal MMF; stripping to EOL keeps
            # this fallback bit-identical to the native scanner, which
            # skips '%' wherever it lands between tokens
            import re

            body = re.sub(r"%[^\n]*", "", body)
        tokens = body.split()
        if len(tokens) % width != 0:
            # trailing garbage or files with per-line comments; fall back
            # to exactly nnz_decl records
            tokens = tokens[: nnz_decl * width]
        arr = np.asarray(tokens, dtype=np.float64)
        if arr.size != nnz_decl * width:
            raise ValueError(
                f"expected {nnz_decl} entries x {width} tokens, "
                f"got {arr.size} tokens"
            )
        arr = arr.reshape(nnz_decl, width)
        row = arr[:, 0].astype(np.int64)
        col = arr[:, 1].astype(np.int64)
        fval = arr[:, 2] if width == 3 else None
    if not zero_based:
        row -= 1
        col -= 1
    if field == "pattern":
        val = np.full(nnz_decl, PATTERN_DEFAULT_VALUE, dtype=dtype)
    else:
        val = np.asarray(fval).astype(dtype)

    if row.min(initial=0) < 0 or col.min(initial=0) < 0 or (
        nnz_decl and (row.max() >= nrows or col.max() >= ncols)
    ):
        raise ValueError("coordinate out of declared bounds")

    if max(nrows, ncols) < (1 << 31):
        # narrow BEFORE the symmetric mirror doubles the arrays (the
        # transient int64 coordinate set is large at audikw_1 scale)
        row = row.astype(np.int32)
        col = col.astype(np.int32)

    if symmetric:
        # canonicalize the stored triangle to lower (row >= col)
        swap = col > row
        row[swap], col[swap] = col[swap].copy(), row[swap].copy()
        if expand_symmetric:
            # mirror strict off-diagonal entries, ref mmf.hpp:279-293
            off = row != col
            row, col, val = (
                np.concatenate([row, col[off]]),
                np.concatenate([col, row[off]]),
                np.concatenate([val, val[off]]),
            )

    # sort by (row, col), ref mmf.hpp:305 — one combined-key radix pass
    # instead of two mergesorts when the key fits int64
    if nrows <= (2**62) // max(ncols, 1):
        order = np.argsort(
            row.astype(np.int64) * max(ncols, 1) + col, kind="stable"
        )
    else:
        order = np.lexsort((col, row))
    row = row[order].astype(index_dtype)
    col = col[order].astype(index_dtype)
    val = val[order]

    hdr = MMFHeader(
        nrows, ncols, nnz_decl, symmetric, field, zero_based, col_wise
    )
    info(
        "mmf: %dx%d nnz=%d symmetric=%s field=%s",
        nrows, ncols, len(row), symmetric, field,
    )
    return hdr, row, col, val


def write_mmf(path, nrows, ncols, row, col, val=None, *, symmetric=False):
    """Write a coordinate ``.mtx`` file (test/bench fixture generator).

    The reference ships no matrices (SURVEY §4); tests generate their own.
    """
    row = np.asarray(row)
    col = np.asarray(col)
    field = "pattern" if val is None else "real"
    sym = "symmetric" if symmetric else "general"
    buf = _io.StringIO()
    buf.write(f"%%MatrixMarket matrix coordinate {field} {sym}\n")
    buf.write(f"{nrows} {ncols} {len(row)}\n")
    if val is None:
        np.savetxt(buf, np.stack([row + 1, col + 1], 1), fmt="%d %d")
    else:
        np.savetxt(
            buf,
            np.stack([row + 1, col + 1, np.asarray(val)], 1),
            fmt="%d %d %.17g",
        )
    with open(path, "w") as f:
        f.write(buf.getvalue())
