"""BELL2 streams and grouped unpermute: CUDA wrappers + twins.

Ports of the Pallas kernels in ``cfs_spmv_tpu/ops/bell2_kernel.py`` that
the fp32 SpMV and SpMM paths reach:

- ``bell2_spmv_tiles`` (kernel B2): ``y = A x`` for one stream; the
  blocks the stream visits are zeroed first, the others left unset;
- ``bell2_spmv_tiles_accum`` (B4): a sparse residual added into a given
  ``y``. The reference walks the residual's chunk grid, which is almost
  all padding; here :func:`compact_stream` turns that grid, once per
  upload, into a row-sorted list of its live entries (``EntryStream``),
  and the kernel runs one thread per entry;
- ``bell2_entries_rows`` (B4 rows): B4 and the seed ``D x`` in one
  pass, ``y = D x + R x`` over flat x and y, where a symmetric float32
  plan's whole off-diagonal part is that entry list: row pointers
  (:func:`entry_rows`, once per upload) in place of each entry's row, the
  work split by path items (rows and entries) so that hub rows spread,
  every row of y written once;
- ``unperm_gather_tiles`` (B3): original-order rows from a
  degree-grouped stream's compact output tiles, in the symmetric applier
  fused with the seed ``D x`` or added into the paired stream's tiles;
- ``sbell_spmv_tiles`` (B5): ``y = (L + Lᵀ) x`` from the paired
  symmetric stream, each stored value driving both its row and its
  transpose;
- their SpMM forms for B right-hand sides, X as (B, x_rows, 128) and the
  output as (B, T, 128) planes: ``bell2_spmm_tiles`` (B7),
  ``bell2_spmm_tiles_accum`` (B8), ``unperm_gather_tiles_mm`` (B9) and
  ``sbell_spmm_tiles`` (B10). The stream kernels read the stream once
  per launch for up to ``_cuda.RHS_GROUP`` planes; the gather serves
  all B planes in one launch. B7's kernel reads X interleaved
  (:func:`interleave_x`: a group's planes of one element side by side,
  one 32-byte sector for 8 planes); its wrapper takes planes or that.

A chunk is an (8, 128) slot grid. Slot (i, j) of chunk c holds the gather
lane ``q = pk & 0x7F``; the window index ``r2`` serving gather lane q of
sublane i sits in bits 7-11 of the packed word at lane q. The x row is
``meta[c, 2] + r2`` for contiguous/deep windows and ``meta[c, 2 + (r2 & 7)]``
for listed ones; the 8 sublanes sum into tile row
``step_block[c // K] * BT + meta[c, 0]``.

The float64 forms of B2 and B7 (``bell2_spmv_tiles_df``, B15, and
``bell2_spmm_tiles_df``, B16) and of B4 and B8 (``bell2_spmv_tiles_accum_df``
and ``bell2_spmm_tiles_accum_df``, B15/B16 on a float64 peel residual) live
in ``ops/bell2_df.py``; they share the checks, the launchers and the twins
of this module, which work in the stream's type.

Every stream wrapper also takes bfloat16 values (``values="bfloat16"``)
beside float32 x and y: its kernel's bf16 instance widens each value as it
loads it and sums in float32, the twins compute on ``vals.float()``, and
a launch counts on the wrapper's ``launches_bf16`` instead of its
``launches``. The paired wrappers (B5, B10) also take float64 values with
float64 x and y (the float64 ``DistSpDMV``'s paired shards), counted in
``launches_f64``: B5 runs the double instance of the paired kernel, and
B10 its double form over planes (``sbell_planes_kernel``), one launch and
one zero pass a group of up to ``_cuda.RHS_GROUP`` planes, as in float.

The TPU-only stream forms (``nib_split``, ``meta_word``, the segmented
word path) are not ported: the CUDA kernel reads the plan's int16
``packed`` and (C, 10) ``meta`` as they are.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils import trace
from . import _cuda

SUBLANES = 8
LANES = 128
META_W = 2 + SUBLANES

__all__ = [
    "EntryStream",
    "EntryRows",
    "compact_stream",
    "entry_rows",
    "bell2_entries_rows",
    "bell2_entries_rows_plain",
    "bell2_spmv_tiles",
    "bell2_spmv_tiles_accum",
    "bell2_spmv_tiles_plain",
    "bell2_spmv_tiles_accum_plain",
    "unperm_gather_tiles",
    "unperm_gather_tiles_plain",
    "sbell_spmv_tiles",
    "sbell_spmv_tiles_plain",
    "bell2_spmm_tiles",
    "bell2_spmm_tiles_plain",
    "interleave_x",
    "planes_of_interleaved",
    "flat_planes",
    "check_interleaved",
    "bell2_spmm_tiles_accum",
    "bell2_spmm_tiles_accum_plain",
    "unperm_gather_tiles_mm",
    "unperm_gather_tiles_mm_plain",
    "sbell_spmm_tiles",
    "sbell_spmm_tiles_plain",
]


def _tiles_padded(num_row_tiles: int, tiles_per_block: int) -> int:
    return -(-num_row_tiles // tiles_per_block) * tiles_per_block


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must live on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_stream(vals, packed, meta, step_block, K,
                  packed_dtype=torch.int16, dtype=torch.float32):
    C = meta.shape[0]
    if meta.ndim != 2 or meta.shape[1] != META_W or meta.dtype != torch.int32:
        raise ValueError(
            f"meta must be (C, {META_W}) int32, got {tuple(meta.shape)} "
            f"{meta.dtype}"
        )
    if tuple(vals.shape) != (C * SUBLANES, LANES):
        raise ValueError(f"vals must be ({C * SUBLANES}, 128)")
    _cuda.check_values(vals, "vals", dtype)
    if (tuple(packed.shape) != (C * SUBLANES, LANES)
            or packed.dtype != packed_dtype):
        raise ValueError(f"packed must be ({C * SUBLANES}, 128) {packed_dtype}")
    if C % K:
        raise ValueError(f"chunk stream not padded to K={K} (C={C})")
    if tuple(step_block.shape) != (C // K,) or step_block.dtype != torch.int32:
        raise ValueError(f"step_block must be ({C // K},) int32")


def _check_x2d(x2d, dtype=torch.float32):
    if x2d.ndim != 2 or x2d.shape[1] != LANES:
        raise ValueError("x2d must be (x_rows, 128)")
    _cuda.check_dtype(x2d, "x2d", dtype)


def _out_buffer(out, shape, dev, dtype=torch.float32):
    """``out``, checked to be a contiguous buffer of ``shape`` and the
    stream's ``dtype`` on ``dev`` (the zero passes write it in 16-byte
    stores), or a fresh one."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=dev)
    if (tuple(out.shape) != shape or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} tensor on {dev}")
    _cuda.check_dtype(out, "out", dtype)
    return out


def _row_sums_plain(vals, packed, meta, step_block, x2d, K, BT, contig):
    """(target tile per chunk, (C, 128) sublane-summed products)."""
    C = meta.shape[0]
    pk = packed.reshape(C, SUBLANES, LANES).to(torch.int64)
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 0x1F, 2, q)  # the field at lane q
    meta64 = meta.to(torch.int64)
    if contig:
        xrow = meta64[:, 2, None, None] + r2
    else:
        cidx = torch.arange(C, device=meta.device)[:, None, None]
        xrow = meta64[:, 2:].reshape(-1)[cidx * SUBLANES + (r2 & 7)]
    xv = x2d.reshape(-1)[xrow * LANES + q]
    rows = (vals.to(x2d.dtype).reshape(C, SUBLANES, LANES) * xv).sum(dim=1)
    tgt = (
        step_block.to(torch.int64).repeat_interleave(K) * BT + meta64[:, 0]
    )
    return tgt, rows


def bell2_spmv_tiles_plain(vals, packed, meta, step_block, x2d, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           contig, out=None, covers=False):
    """Plain PyTorch twin of :func:`bell2_spmv_tiles` (any device):
    vectorised gather over all chunks, sum over sublanes, ``index_add_``.
    ``covers``: the whole output is zeroed, as the kernels do for a stream
    that visits every block."""
    K, BT = chunks_per_step, tiles_per_block
    TP = _tiles_padded(num_row_tiles, BT)
    if out is None:
        out = torch.empty((TP, LANES), dtype=x2d.dtype, device=x2d.device)
    if covers:
        out.zero_()
    else:
        out.view(-1, BT, LANES)[torch.unique(step_block).long()] = 0
    tgt, rows = _row_sums_plain(vals, packed, meta, step_block, x2d, K, BT,
                                contig)
    out.index_add_(0, tgt, rows)
    return out[:num_row_tiles]


@dataclasses.dataclass
class EntryStream:
    """The live entries of a sparse accumulating stream, sorted by row:
    what ``bell2_spmv_tiles_accum`` and ``bell2_spmm_tiles_accum`` (and
    their float64 forms) read in place of the chunk grid (12 bytes an entry
    in float32, 10 with bfloat16 values, 16 in float64)."""

    rows: torch.Tensor  # (E,) int32 flat index into the (T, 128) y tiles
    cols: torch.Tensor  # (E,) int32 flat index into the (x_rows, 128) x
    vals: torch.Tensor  # (E,) in the stream's type (bfloat16 for float32)
    #: the tiles y and the rows x must at least hold (largest index + 1,
    #: in tiles of 128): the kernel reads and adds without bounds checks
    min_tiles: int
    min_x_rows: int

    @property
    def count(self) -> int:
        return self.rows.shape[0]

    def to(self, device, vals_dtype=None) -> "EntryStream":
        """The entries on ``device``, their values cast to ``vals_dtype``
        (default: kept)."""
        return dataclasses.replace(
            self, rows=self.rows.to(device), cols=self.cols.to(device),
            vals=self.vals.to(device, vals_dtype or self.vals.dtype))


def compact_stream(vals, packed, meta, step_block, *, chunks_per_step,
                   tiles_per_block, contig, num_row_tiles,
                   x_rows, device="cpu") -> EntryStream:
    """The nonzero slots of a one-sided chunk stream (host numpy arrays,
    as a ``Bell2Plan`` holds them) as an :class:`EntryStream` on
    ``device``, decoded there: at upload the grid goes to the card and
    only its entries stay, so the host never walks the grid's padding.

    Decodes as :func:`_row_sums_plain` does: slot (i, l) of chunk c holds
    the gather lane ``q = pk & 0x7F``; its window index r2 is bits 7-11
    of the word at lane q of the same sublane; the x row is
    ``meta[c, 2] + r2`` when ``contig``, else ``meta[c, 2 + (r2 & 7)]``;
    the slot adds into row ``(step_block[c // K] * BT + meta[c, 0]) * 128
    + l``. Slots whose value is 0 (padding, and stored explicit zeros)
    drop out. The entries are sorted by row, stably, so within a row they
    keep the stream's order (the same entries, in the same order, on any
    device). Raises ``ValueError`` when a row lies past ``num_row_tiles``
    tiles, a column past ``x_rows`` rows of x, or either does not fit
    int32.
    """
    K, BT = chunks_per_step, tiles_per_block

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    meta = t(meta).long()
    C = meta.shape[0]
    vals = t(vals).reshape(C, SUBLANES, LANES)
    pk = t(packed).reshape(C, SUBLANES, LANES)
    c, i, lane = torch.nonzero(vals, as_tuple=True)  # live slots only
    q = pk[c, i, lane].long() & 0x7F
    r2 = (pk[c, i, q].long() >> 7) & 0x1F
    del pk
    xrow = meta[c, 2] + r2 if contig else meta[c, 2 + (r2 & 7)]
    tile = t(step_block).long()[c // K] * BT + meta[c, 0]
    rows, cols = tile * LANES + lane, xrow * LANES + q
    del q, r2, xrow, tile
    if rows.numel():
        limit = np.iinfo(np.int32).max
        if (rows.min().item() < 0
                or rows.max().item() >= min(num_row_tiles * LANES, limit)):
            raise ValueError(
                f"an entry's row lies outside the {num_row_tiles} output "
                "tiles (or past int32)")
        if (cols.min().item() < 0
                or cols.max().item() >= min(x_rows * LANES, limit)):
            raise ValueError(
                f"an entry's column lies outside the {x_rows} rows of x "
                "(or past int32)")
    rows, order = torch.sort(rows, stable=True)
    return EntryStream(
        rows=rows.int(),
        cols=cols[order].int(),
        vals=vals[c, i, lane][order],
        min_tiles=int(rows[-1]) // LANES + 1 if rows.numel() else 0,
        min_x_rows=int(cols.max()) // LANES + 1 if rows.numel() else 0,
    )


def bell2_spmv_tiles_accum_plain(entries, x2d, y_tiles):
    """Plain PyTorch twin of :func:`bell2_spmv_tiles_accum` (any device):
    one gather, one product and one ``index_add_`` over the entries, in
    the type of x (bfloat16 values widened first)."""
    prod = (entries.vals.to(x2d.dtype)
            * x2d.reshape(-1).index_select(0, entries.cols))
    y_tiles.view(-1).index_add_(0, entries.rows, prod)
    return y_tiles


def _launch_bell2(vals, packed, meta, step_block, x3d, y3d, K, BT, contig,
                  name, covers=False):
    """Launch the one-sided stream kernel (after its zero pass) over the
    output planes ``y3d``; returns the number of launches (one per group
    of planes). ``x3d``: for float64 values planes, for float32 one plane
    or an interleaved X (:func:`interleave_x`). The launcher takes the
    planes' tile count, which zeroes them whole when the stream
    ``covers`` every block (0: the zero kernel, visited blocks)."""
    fn = _cuda.entry("bell2_spmv", vals.dtype)
    tiles = y3d.shape[1] if covers else 0
    return _cuda.launch_groups(name, x3d, y3d, functools.partial(
        fn, vals.data_ptr(), packed.data_ptr(), meta.data_ptr(),
        step_block.data_ptr(), meta.shape[0], K, BT, int(contig), tiles))


def bell2_spmv_tiles(vals, packed, meta, step_block, x2d, *,
                     num_row_tiles, chunks_per_step, tiles_per_block,
                     contig, out=None, covers=False):
    """y tiles (T, 128) = A @ x for one BELL2 stream.

    ``vals``/``packed``: (C*8, 128) float32/int16; ``meta``: (C, 10)
    int32; ``step_block``: (C/K,) int32; ``x2d``: (x_rows, 128) float32.
    ``contig`` selects contiguous/deep windows (x row ``meta[c,2] + r2``)
    over listed ones. The output is a (ceil(T/BT)*BT, 128) buffer
    (``out``, or ``torch.empty``) of which the blocks the stream visits
    are zeroed and accumulated; unvisited blocks keep whatever the buffer
    held. ``covers=True`` says the stream visits every block (the upload's
    ``Bell2Device.covers``): the whole buffer is zeroed in one pass, which
    is the same result. Returns its first T rows.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    return _spmv_tiles(bell2_spmv_tiles, torch.float32, vals, packed, meta,
                       step_block, x2d, num_row_tiles, chunks_per_step,
                       tiles_per_block, contig, out, covers)


def _spmv_tiles(wrapper, dtype, vals, packed, meta, step_block, x2d,
                num_row_tiles, K, BT, contig, out, covers=False):
    """The body of :func:`bell2_spmv_tiles` for a stream of ``dtype``
    values; a kernel launch counts on ``wrapper`` (the float64 form is
    ``bell2_df.bell2_spmv_tiles_df``)."""
    dev = _device_of(vals, packed, meta, step_block, x2d)
    _check_stream(vals, packed, meta, step_block, K, dtype=dtype)
    _check_x2d(x2d, dtype)
    out = _out_buffer(out, (_tiles_padded(num_row_tiles, BT), LANES), dev,
                      dtype)
    if dev.type == "cpu":
        return bell2_spmv_tiles_plain(
            vals, packed, meta, step_block, x2d,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, contig=contig, out=out, covers=covers,
        )
    _cuda.count(wrapper, vals.dtype, _launch_bell2(
        vals, packed, meta, step_block, x2d[None], out[None], K, BT, contig,
        wrapper.__name__, covers))
    return out[:num_row_tiles]


def _check_entries(entries, x_rows, tiles):
    """Shared by B4 and B8: the entry arrays' types, and that x and y
    hold every index the entries name."""
    if (entries.rows.dtype != torch.int32 or entries.cols.dtype != torch.int32
            or entries.rows.ndim != 1
            or not entries.rows.shape == entries.cols.shape
            == entries.vals.shape):
        raise ValueError("entries must hold (E,) int32 rows and cols and "
                         "(E,) vals")
    if x_rows < entries.min_x_rows:
        raise ValueError(f"x must hold at least {entries.min_x_rows} rows "
                         f"of 128, got {x_rows}")
    if tiles < entries.min_tiles:
        raise ValueError(f"y_tiles must hold at least {entries.min_tiles} "
                         f"rows of 128 (the largest entry row), got {tiles}")


def _launch_entries(entries, x3d, y3d, name):
    """Launch the entry kernel in the type of ``entries.vals`` over plane
    stacks; returns the number of launches (one per group of planes)."""
    fn = _cuda.entry("bell2_entries", entries.vals.dtype)
    return _cuda.launch_groups(name, x3d, y3d, functools.partial(
        fn, entries.rows.data_ptr(), entries.cols.data_ptr(),
        entries.vals.data_ptr(), entries.count))


def bell2_spmv_tiles_accum(entries, x2d, y_tiles):
    """``y_tiles += R @ x`` for a sparse accumulating stream R, given as
    its :class:`EntryStream` (``compact_stream`` of the plan's chunk
    grid).

    ``x2d``: (x_rows, 128) float32; ``y_tiles``: (T, 128) float32 with at
    least ``entries.min_tiles`` tiles (the entries' values float32 or
    bfloat16), added into in place (the reference
    aliases it) and returned. Rows no entry names keep their values bit
    for bit.

    Padded slots and stored zeros are not among the entries. For finite x
    that changes no result. For a non-finite x it does: the reference's
    chunk form multiplies the x at every padded slot's gather address by
    0 and so spreads NaN into rows the matrix does not couple to it; the
    entry form does not. That spread is a property of the chunk layout,
    not a contract.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    return _spmv_accum(bell2_spmv_tiles_accum, torch.float32, entries, x2d,
                       y_tiles)


def _spmv_accum(wrapper, dtype, entries, x2d, y_tiles):
    """The body of :func:`bell2_spmv_tiles_accum` for entries of ``dtype``
    values; a kernel launch counts on ``wrapper`` (the float64 form is
    ``bell2_df.bell2_spmv_tiles_accum_df``)."""
    dev = _device_of(entries.rows, entries.cols, entries.vals, x2d, y_tiles)
    _check_x2d(x2d, dtype)
    if y_tiles.ndim != 2 or y_tiles.shape[1] != LANES:
        raise ValueError("y_tiles must be (T, 128)")
    _cuda.check_values(entries.vals, "entries.vals", dtype)
    _cuda.check_dtype(y_tiles, "y_tiles", dtype)
    _check_entries(entries, x2d.shape[0], y_tiles.shape[0])
    if dev.type == "cpu":
        return bell2_spmv_tiles_accum_plain(entries, x2d, y_tiles)
    if entries.count:
        _cuda.count(wrapper, entries.vals.dtype, _launch_entries(
            entries, x2d[None], y_tiles[None], wrapper.__name__))
    return y_tiles


#: path items (rows and entries) a CTA of ``bell2_entries_kernel_rows``
#: takes: its ``kRowsItems``, 256 threads of 5
ROWS_ITEMS = 256 * 5


@dataclasses.dataclass
class EntryRows:
    """Row pointers over an :class:`EntryStream` of ``nrows`` rows and the
    stream's merge-path split (``bell2_entries_rows``): the walk over rows
    and entries together, ``nrows + count`` items (a row's entries, then
    its end), cut every ``ROWS_ITEMS`` items."""

    ptr: torch.Tensor  # (nrows + 1,) int32: row r's entries ptr[r]:ptr[r+1]
    #: (slices + 1, 2) int32: the (row, entry) where each slice starts, the
    #: largest row i with ptr[i] + i <= its first item; the last is
    #: (nrows, count)
    tiles: torch.Tensor
    nrows: int

    @property
    def slices(self) -> int:
        return self.tiles.shape[0] - 1


def entry_rows(entries: EntryStream, nrows: int) -> EntryRows:
    """The :class:`EntryRows` of ``entries`` (rows sorted, as
    :func:`compact_stream` gives them) over ``nrows`` rows and columns, on
    the entries' device. Raises ``ValueError`` where an entry's row or
    column is not below ``nrows``, or the path's items do not fit int32."""
    rows, dev = entries.rows.long(), entries.rows.device
    E = entries.count
    if nrows + E >= 2**31:
        raise ValueError("the entries' path passes int32")
    if E and (int(rows[0]) < 0 or int(rows[-1]) >= nrows
              or int(entries.cols.min()) < 0
              or int(entries.cols.max()) >= nrows):
        raise ValueError(f"an entry lies outside the {nrows} rows and "
                         "columns")
    ptr = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(rows, minlength=nrows), 0, out=ptr[1:])
    L = nrows + E
    k = torch.clamp(torch.arange(max(1, -(-L // ROWS_ITEMS)) + 1,
                                 device=dev) * ROWS_ITEMS, max=L)
    path = ptr + torch.arange(nrows + 1, device=dev)
    i = torch.searchsorted(path, k, right=True) - 1
    return EntryRows(ptr=ptr.int(),
                     tiles=torch.stack([i, k - i], 1).int().contiguous(),
                     nrows=nrows)


def bell2_entries_rows_plain(entries, er, diag, x):
    """Plain PyTorch twin of :func:`bell2_entries_rows` (any device): D x,
    then one gather, one product and one ``index_add_`` over the entries,
    their rows read off the row pointers."""
    rows = torch.repeat_interleave(
        torch.arange(er.nrows, device=x.device), er.ptr.diff().long())
    y = diag * x
    y.index_add_(0, rows, entries.vals * x.index_select(0, entries.cols))
    return y


def bell2_entries_rows(entries, er, diag, x, out=None):
    """``y = D x + R x`` for R the entries of an :class:`EntryStream` under
    their :class:`EntryRows` ``er``, D the ``diag`` (n,), x (n,), all
    float32, n = ``er.nrows``: a (n,) y, every row written once (a row no
    entry names reads ``diag[r] * x[r]``), the same bits on every call.
    ``out``: the kernel's buffer, (n + 2 * er.slices,) float32, y first
    and then the slices' carries (default: a fresh one); y is its first n.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (and, over more than one slice, its carry pass) or raises.
    """
    dev = _device_of(er.ptr, er.tiles, entries.cols, entries.vals, diag, x)
    n = er.nrows
    if x.shape != (n,) or diag.shape != (n,):
        raise ValueError(f"x and diag must be ({n},), got {tuple(x.shape)} "
                         f"and {tuple(diag.shape)}")
    for t, name in ((entries.vals, "entries.vals"), (diag, "diag"),
                    (x, "x")):
        _cuda.check_dtype(t, name, torch.float32)
    if dev.type == "cpu":
        return bell2_entries_rows_plain(entries, er, diag, x)
    nb = er.slices
    # y, then the slices' carries: nb rows (int32 bits) and nb sums
    buf = _out_buffer(out, (n + 2 * nb,), dev)
    fn = _cuda.lib().cfs_bell2_entries_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with trace.span("cfs.launch", entry=fn.__name__):
            err = fn(er.ptr.data_ptr(), entries.cols.data_ptr(),
                     entries.vals.data_ptr(), er.tiles.data_ptr(), nb,
                     diag.data_ptr(), x.data_ptr(), buf.data_ptr(),
                     buf.data_ptr() + 4 * n, buf.data_ptr() + 4 * (n + nb),
                     n, ROWS_ITEMS, stream)
    _cuda.check(err, "bell2_entries_rows")
    bell2_entries_rows.launches += int(n > 0)
    return buf[:n]


def _gathered(pk2d, rows, g_tiles):
    """P g: one flat gather plus ``where``; rows with ``pk < 0`` read
    exact 0."""
    pk = pk2d.reshape(-1).to(torch.int64)
    W = rows.shape[1]
    blk = torch.arange(pk.shape[0], device=pk.device) >> 10
    p = pk.clamp(min=0)
    tile = rows.reshape(-1).to(torch.int64)[blk * W + (p >> 7)]
    v = g_tiles.reshape(-1)[tile * LANES + (p & 0x7F)]
    out = torch.where(pk < 0, torch.zeros_like(v), v)
    return out.reshape(pk2d.shape)


def _composed(ot, seed, into, tiles):
    """The fused unpermute forms written as the ops they replace, over
    (B, nb*8, 128) gathered planes ``ot``: with ``seed`` = (diag, X), the
    pad of (diag · X)ᵀ to ``tiles`` tiles plus ``ot`` padded or cut to
    them; with ``into`` (B, T, 128), ``into += ot`` over its T tiles."""
    if seed is None and into is None:
        return ot
    base = into
    if seed is not None:
        diag, x = seed
        base = ot.new_zeros((ot.shape[0], tiles * LANES))
        base[:, :diag.shape[0]] = (diag[:, None] * x).T
        base = base.view(ot.shape[0], tiles, LANES)
    NT = base.shape[1]
    if ot.shape[1] < NT:
        ot = torch.nn.functional.pad(ot, (0, 0, 0, NT - ot.shape[1]))
    if into is not None:
        into += ot[:, :NT]
        return into
    return base + ot[:, :NT]


def unperm_gather_tiles_plain(pk2d, rows, g_tiles, *, seed=None, into=None,
                              tiles=None):
    """Plain PyTorch twin of :func:`unperm_gather_tiles` (any device):
    one flat gather plus ``where``, and the fused forms as the composed
    ops (the pad of the seed ``diag * x``, the pad of the gather, the
    add)."""
    ot = _gathered(pk2d, rows, g_tiles)
    if seed is not None:  # x as one column of an (m, 1) X
        seed = (seed[0], seed[1][:, None])
    return _composed(ot[None], seed, None if into is None else into[None],
                     tiles)[0]


def unperm_gather_tiles(pk2d, rows, g_tiles, *, seed=None, into=None,
                        tiles=None):
    """(nb*8, 128) original-order y tiles from grouped output tiles.

    ``pk2d``: (nb*8, 128) int32 words ``q | w << 7`` (-1: exact 0);
    ``rows``: (nb, W) int32 tile rows of ``g_tiles`` each 1024-row block
    reads; ``g_tiles``: (T, 128) float32. A pure gather, so the result is
    bit-exact on every device.

    The fused forms of the symmetric applier, in the same launch:

    - ``seed`` = (diag, x), two (m,) float32 vectors (x at any stride), and
      ``tiles``: returns (tiles, 128) tiles holding ``diag * x`` (0 past
      m) plus the gather (0 past its nb*8 tiles);
    - ``into``, (T, 128) contiguous float32 tiles: ``into += P g`` over its
      T tiles (0 added past the gather), returned.

    Each equals the composed ops bit for bit: the product and the sum
    round once each, as ``pad_x(diag * x, tiles) + pad(P g)`` does.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    dev = _device_of(pk2d, rows, g_tiles)
    _check_unperm(pk2d, rows)
    if g_tiles.ndim != 2 or g_tiles.shape[1] != LANES:
        raise ValueError("g_tiles must be (T, 128)")
    _cuda.check_dtype(g_tiles, "g_tiles", torch.float32)
    seed_mm = None
    if seed is not None:  # x as one column of an (m, 1) X
        seed_mm = (seed[0], _check_seed_x(seed, 1, dev, vector=True))
    into3d = None if into is None else into[None]
    _check_fused(seed, into3d, tiles, dev, 1)
    if dev.type == "cpu":
        return unperm_gather_tiles_plain(pk2d, rows, g_tiles, seed=seed,
                                         into=into, tiles=tiles)
    out = _launch_unperm(pk2d, rows, g_tiles[None], seed_mm, into3d, tiles,
                         "unperm_gather_tiles")
    unperm_gather_tiles.launches += 1
    return out[0]


def _check_unperm(pk2d, rows):
    nb = rows.shape[0]
    if tuple(pk2d.shape) != (nb * SUBLANES, LANES) or pk2d.dtype != torch.int32:
        raise ValueError(f"pk2d must be ({nb * SUBLANES}, 128) int32")
    if rows.ndim != 2 or rows.dtype != torch.int32:
        raise ValueError("rows must be (nb, W) int32")


def _check_seed_x(seed, B, dev, vector=False):
    """The seed's x as (m, B), checked against its diag (m,) float32
    contiguous on ``dev``; a vector x (``vector``) is one column."""
    diag, x = seed
    if diag.ndim != 1 or not diag.is_contiguous():
        raise ValueError("the seed's diag must be a contiguous (m,) vector")
    want = (diag.shape[0],) if vector else (diag.shape[0], B)
    if tuple(x.shape) != want:
        raise ValueError(f"the seed's x must be {want}, got "
                         f"{tuple(x.shape)}")
    for name, t in (("diag", diag), ("x", x)):
        _cuda.check_dtype(t, f"the seed's {name}", torch.float32)
        if t.device != dev:
            raise ValueError("all operands must live on one device")
    return x[:, None] if vector else x


def _check_fused(seed, into3d, tiles, dev, B):
    """At most one fused form; the seed's tile count holds its rows; the
    ``into`` planes (B, T, 128) float32 on ``dev``, each contiguous."""
    if seed is not None and into3d is not None:
        raise ValueError("give the seed or the tiles to add into, not both")
    if seed is not None and (tiles is None
                             or tiles * LANES < seed[0].shape[0]):
        raise ValueError("the seed needs the output's tile count, at least "
                         "its rows / 128")
    if seed is None and tiles is not None:
        raise ValueError("tiles is the seed form's output height")
    if into3d is not None:
        _cuda.check_planes(into3d, "into", dev, torch.float32, B=B)


def _launch_unperm(pk2d, rows, g3d, seed, into3d, tiles, name):
    """One launch gathers every plane of ``g3d``; returns the (B, rows,
    128) output planes: fresh ones of nb*8 tiles (the gather) or of
    ``tiles`` tiles (the seed), or ``into3d``."""
    B, n_gather = g3d.shape[0], pk2d.numel()
    diag = x = None
    x_row = x_col = n_seed = 0
    if into3d is not None:
        out, mode = into3d, 2
    elif seed is not None:
        diag, x = seed
        out = torch.empty((B, tiles, LANES), dtype=torch.float32,
                          device=g3d.device)
        x_row, x_col, n_seed, mode = x.stride(0), x.stride(1), x.shape[0], 1
    else:
        out, mode = torch.empty((B, *pk2d.shape), dtype=torch.float32,
                                device=g3d.device), 0
    fn = _cuda.lib().cfs_unperm_gather
    with torch.cuda.device(out.device):
        args = (pk2d.data_ptr(), rows.data_ptr(), rows.shape[1],
                g3d.data_ptr(), g3d.stride(0), out.data_ptr(), out.stride(0),
                n_gather, out[0].numel(),
                None if diag is None else diag.data_ptr(),
                None if x is None else x.data_ptr(), x_row, x_col, n_seed,
                mode, B, torch.cuda.current_stream(out.device).cuda_stream)
        with trace.span("cfs.launch", entry=fn.__name__):
            err = fn(*args)
    _cuda.check(err, name)
    return out


def unperm_gather_tiles_mm_plain(pk2d, rows, g_tiles, *, seed=None,
                                 into=None, tiles=None):
    """Plain PyTorch twin of :func:`unperm_gather_tiles_mm`: B3's gather
    once per plane, then the fused forms as the composed ops."""
    ot = torch.stack([_gathered(pk2d, rows, g) for g in g_tiles])
    return _composed(ot, seed, into, tiles)


def unperm_gather_tiles_mm(pk2d, rows, g_tiles, *, seed=None, into=None,
                           tiles=None):
    """(B, nb*8, 128) original-order Y tiles from grouped (B, T, 128)
    ``g_tiles`` (planes each contiguous, any plane stride); other
    operands as :func:`unperm_gather_tiles`. One launch decodes each
    output row's word once and gathers it from all B planes; bit-exact
    on every device. The fused forms as :func:`unperm_gather_tiles`, over
    planes: ``seed`` = (diag, X) with X (m, B) read in place at its
    strides, giving (B, tiles, 128); ``into`` (B, T, 128) planes, each
    contiguous."""
    dev = _device_of(pk2d, rows)
    _check_unperm(pk2d, rows)
    B = _cuda.check_planes(g_tiles, "g_tiles", dev, torch.float32)
    if seed is not None:
        _check_seed_x(seed, B, dev)
    _check_fused(seed, into, tiles, dev, B)
    if dev.type == "cpu":
        return unperm_gather_tiles_mm_plain(pk2d, rows, g_tiles, seed=seed,
                                            into=into, tiles=tiles)
    out = _launch_unperm(pk2d, rows, g_tiles, seed, into, tiles,
                         "unperm_gather_tiles_mm")
    unperm_gather_tiles_mm.launches += 1
    return out


def sbell_spmv_tiles_plain(vals, packed, meta, step_block, x2d, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           transpose_windows, out=None):
    """Plain PyTorch twin of :func:`sbell_spmv_tiles` (any device): the
    paired plan decoded into what it means. Every stored strict-lower
    entry (r, c, v) adds ``v x[c]`` to y[r] (the row side, B2's gather)
    and ``v x[r]`` to y[c] (the transpose side, at the window its r2
    field names); the whole output is zeroed first."""
    C = meta.shape[0]
    K, BT, TW = chunks_per_step, tiles_per_block, transpose_windows
    TP = _tiles_padded(num_row_tiles, BT)
    if out is None:
        out = torch.empty((TP, LANES), dtype=x2d.dtype, device=x2d.device)
    out.zero_()
    pk = packed.reshape(C, SUBLANES, LANES).to(torch.int64)
    v = vals.to(x2d.dtype).reshape(C, SUBLANES, LANES)
    meta64 = meta.to(torch.int64)
    win = meta64[:, 2:2 + TW]  # (C, TW) window tiles
    tgt = step_block.to(torch.int64).repeat_interleave(K) * BT + meta64[:, 0]
    xf = x2d.reshape(-1)
    cidx = torch.arange(C, device=meta.device)[:, None, None]

    def window_tile(r2):
        # tile of window r2 (< TW) of each slot's chunk; r2 >= TW is masked
        return win.reshape(-1)[cidx * TW + r2.clamp(max=TW - 1)]

    # row side: y[tgt, l] += sum_i v[i, l] x[win[r2 at lane q], q]
    q = pk & 0x7F
    r2 = torch.gather((pk >> 7) & 7, 2, q)
    xv = xf[window_tile(r2) * LANES + q]
    xv = torch.where(r2 < TW, xv, torch.zeros_like(xv))
    out.index_add_(0, tgt, (v * xv).sum(dim=1))
    # transpose side: y[win[r2], p] += v[i, src] x[tgt, src] at slot (i, p)
    t2 = (pk >> 7) & 7
    src = (pk >> 10) & 0x7F
    prod = torch.gather(v, 2, src) * xf[tgt[:, None, None] * LANES + src]
    prod = torch.where(t2 < TW, prod, torch.zeros_like(prod))
    lane = torch.arange(LANES, device=meta.device)
    dst = window_tile(t2) * LANES + lane
    out.view(-1).index_add_(0, dst.reshape(-1), prod.reshape(-1))
    return out[:num_row_tiles]


def sbell_spmv_tiles(vals, packed, meta, step_block, x2d, *,
                     num_row_tiles, chunks_per_step, tiles_per_block,
                     transpose_windows, out=None):
    """y tiles (T, 128) = (L + Lᵀ) x from the paired strict-lower stream.

    ``vals``: (C*8, 128) float32 or bfloat16, or float64; ``packed``:
    (C*8, 128) int32 words
    ``q | r2 << 7 | src << 10`` (r2 = 7: no transpose entry at that
    slot); ``meta``: (C, 10) int32 whose windows ``meta[c, 2:2+TW]`` are
    tiles of the chunk's own output block; ``step_block``: (C/K,) int32;
    ``x2d``: (x_rows, 128) float32 (float64 for float64 values), and the
    output of x's type; ``transpose_windows`` (TW) is 2 or 4.
    The output is a (ceil(T/BT)*BT, 128) buffer (``out``, or
    ``torch.empty``) that is zeroed whole, then accumulated: a paired
    plan visits every block (``sym_to_device`` checks it). Returns its
    first T rows.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises.
    """
    K, BT, TW = chunks_per_step, tiles_per_block, transpose_windows
    dev = _device_of(vals, packed, meta, step_block, x2d)
    dtype = _cuda.xy_dtype(vals)
    _check_sbell(vals, packed, meta, step_block, K, TW, dtype)
    _check_x2d(x2d, dtype)
    out = _out_buffer(out, (_tiles_padded(num_row_tiles, BT), LANES), dev,
                      dtype)
    if dev.type == "cpu":
        return sbell_spmv_tiles_plain(
            vals, packed, meta, step_block, x2d,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, transpose_windows=TW, out=out,
        )
    _cuda.count(sbell_spmv_tiles, vals.dtype, _launch_sbell(
        vals, packed, meta, step_block, x2d[None], out[None], K, BT, TW,
        "sbell_spmv_tiles"), f64_apart=True)
    return out[:num_row_tiles]


def _check_sbell(vals, packed, meta, step_block, K, TW,
                 dtype=torch.float32):
    _check_stream(vals, packed, meta, step_block, K, torch.int32, dtype)
    if TW not in (2, 4):
        raise ValueError(f"transpose_windows must be 2 or 4, got {TW}")


def _launch_sbell(vals, packed, meta, step_block, x3d, y3d, K, BT, TW, name):
    """Launch the paired-stream kernel over plane stacks, each group after
    a zero pass over the whole of its planes of ``y3d``; returns the
    number of launches (one per group of up to ``_cuda.RHS_GROUP``
    planes). A refused launch, or a refused shared-memory size of the
    double kernel over planes, raises."""
    fn = _cuda.entry("sbell_spmv", vals.dtype)
    return _cuda.launch_groups(name, x3d, y3d, functools.partial(
        fn, vals.data_ptr(), packed.data_ptr(), meta.data_ptr(),
        step_block.data_ptr(), meta.shape[0], K, BT, TW, y3d.shape[1]))


def group_widths(B: int) -> list[int]:
    """Rows of an interleaved X of B planes, group by group: a group of
    ``_cuda.RHS_GROUP`` planes takes 8, the last group of r planes the
    width of the kernel instance that serves it (1, 2, 4 or 8)."""
    G = _cuda.RHS_GROUP
    r = B % G
    return [G] * (B // G) + ([1 if r == 1 else 2 if r == 2 else
                              4 if r <= 4 else G] if r else [])


def interleave_x(x, x_rows):
    """(m, B) X → the interleaved X that B7's kernel reads: a contiguous
    zero-padded (W, x_rows * 128) tensor, W = ``sum(group_widths(B))``,
    in which the group of planes b0 .. b0 + w - 1 (b0 a multiple of 8, w
    its width) fills rows b0 .. b0 + w - 1 element by element: element e
    of plane b0 + k sits at flat index b0 * x_rows * 128 + e * w + k. An
    element's planes of a group are one 8-, 16- or 32-byte load, and each
    group starts where plane b0 would, 32-byte aligned. One plane is that
    plane. One zeroed buffer and one copy a group."""
    m, B = x.shape
    n = x_rows * LANES
    with trace.span("cfs.stage", op="interleave_x") as s:
        out = s.wrote(x.new_zeros((sum(group_widths(B)), n)))
        flat = out.view(-1)
        for g, w in enumerate(group_widths(B)):
            b0 = g * _cuda.RHS_GROUP
            nr = min(_cuda.RHS_GROUP, B - b0)
            flat[b0 * n:(b0 + w) * n].view(n, w)[:m, :nr] = x[:, b0:b0 + nr]
    return out


def flat_planes(x_il, planes):
    """The (B, n) planes, each flat, of an interleaved X ``x_il`` (W, n) of
    ``planes`` = B of them (:func:`interleave_x`, or an (m, B) X viewed
    as (B, m): any n)."""
    n = x_il.shape[1]
    flat = x_il.reshape(-1)
    groups = []
    for g, w in enumerate(group_widths(planes)):
        b0 = g * _cuda.RHS_GROUP
        nr = min(_cuda.RHS_GROUP, planes - b0)
        groups.append(flat[b0 * n:(b0 + w) * n].view(n, w).T[:nr])
    return torch.cat(groups)


def planes_of_interleaved(x_il, planes):
    """The (B, x_rows, 128) planes of an interleaved X ``x_il`` of
    ``planes`` = B of them (:func:`interleave_x`)."""
    return flat_planes(x_il, planes).reshape(planes, -1, LANES)


def bell2_spmm_tiles_plain(vals, packed, meta, step_block, x3d, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           contig, out=None, covers=False, planes=None):
    """Plain PyTorch twin of :func:`bell2_spmm_tiles`: B2's twin once per
    plane (of the interleaved X's planes, given ``planes``)."""
    if planes is not None:
        x3d = planes_of_interleaved(x3d, planes)
    if out is None:
        out = x3d.new_empty((x3d.shape[0],
                             _tiles_padded(num_row_tiles, tiles_per_block),
                             LANES))
    for b in range(x3d.shape[0]):
        bell2_spmv_tiles_plain(vals, packed, meta, step_block, x3d[b],
                               num_row_tiles=num_row_tiles,
                               chunks_per_step=chunks_per_step,
                               tiles_per_block=tiles_per_block,
                               contig=contig, out=out[b], covers=covers)
    return out[:, :num_row_tiles]


def bell2_spmm_tiles(vals, packed, meta, step_block, x3d, *,
                     num_row_tiles, chunks_per_step, tiles_per_block,
                     contig, out=None, covers=False, planes=None):
    """Y tiles (B, T, 128) = A @ X for one BELL2 stream and B right-hand
    sides.

    ``x3d``: (B, x_rows, 128) float32 planes, each contiguous (any plane
    stride), which the wrapper interleaves for the kernel (one copy); or,
    given ``planes`` = B, X already interleaved (:func:`interleave_x`, as
    the appliers pass it). The output is a contiguous (B,
    ceil(T/BT)*BT, 128) buffer (``out``, or ``torch.empty``) of which, in
    every plane, the blocks the stream visits are zeroed and accumulated;
    unvisited blocks keep whatever the buffer held (with ``covers=True``,
    as :func:`bell2_spmv_tiles`, the whole planes are zeroed). Returns its
    first T rows of each plane. Other operands as
    :func:`bell2_spmv_tiles`.

    A CPU tensor takes the plain twin; on a CUDA tensor the kernel
    launches once per group of up to ``_cuda.RHS_GROUP`` planes, reading
    the stream once per group, or raises.
    """
    return _spmm_tiles(bell2_spmm_tiles, torch.float32, vals, packed, meta,
                       step_block, x3d, num_row_tiles, chunks_per_step,
                       tiles_per_block, contig, out, covers, planes)


def check_interleaved(x_il, dev, planes, padded=True, dtype=torch.float32):
    """An interleaved X of ``planes`` planes of ``dtype`` (float32; B12's
    double instance reads float64) on ``dev``, aligned for the kernels'
    vector loads; returns ``planes``. ``padded``: its rows are whole tiles
    of 128 (B7 reads without bounds checks; B12 takes any length and reads
    zero past it)."""
    W = sum(group_widths(planes)) if planes >= 1 else 0
    if (W == 0 or x_il.ndim != 2 or x_il.shape[0] != W
            or (padded and x_il.shape[1] % LANES)):
        raise ValueError(f"an interleaved X of {planes} planes must be "
                         f"({W}, x_rows * 128), got {tuple(x_il.shape)}")
    _cuda.check_dtype(x_il, "x3d", dtype)
    if x_il.device != dev or not x_il.is_contiguous():
        raise ValueError(f"an interleaved X must be contiguous on {dev}")
    if x_il.data_ptr() % 32:
        raise ValueError("an interleaved X must start 32-byte aligned")
    return planes


def _spmm_tiles(wrapper, dtype, vals, packed, meta, step_block, x3d,
                num_row_tiles, K, BT, contig, out, covers=False,
                planes=None):
    """The body of :func:`bell2_spmm_tiles` for a stream of ``dtype``
    values; kernel launches count on ``wrapper`` (the float64 form is
    ``bell2_df.bell2_spmm_tiles_df``, which takes planes only)."""
    dev = _device_of(vals, packed, meta, step_block)
    _check_stream(vals, packed, meta, step_block, K, dtype=dtype)
    B = (_cuda.check_planes(x3d, "x3d", dev, dtype) if planes is None
         else check_interleaved(x3d, dev, planes))
    out = _out_buffer(out, (B, _tiles_padded(num_row_tiles, BT), LANES),
                      dev, dtype)
    if dev.type == "cpu":
        return bell2_spmm_tiles_plain(
            vals, packed, meta, step_block, x3d,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, contig=contig, out=out, covers=covers,
            planes=planes,
        )
    if dtype == torch.float32 and planes is None and B > 1:
        x3d = interleave_x(x3d.reshape(B, -1).T, x3d.shape[1])
    _cuda.count(wrapper, vals.dtype, _launch_bell2(
        vals, packed, meta, step_block, x3d, out, K, BT, contig,
        wrapper.__name__, covers))
    return out[:, :num_row_tiles]


def bell2_spmm_tiles_accum_plain(entries, x3d, y_tiles):
    """Plain PyTorch twin of :func:`bell2_spmm_tiles_accum`: B4's twin
    once per plane."""
    for b in range(x3d.shape[0]):
        bell2_spmv_tiles_accum_plain(entries, x3d[b], y_tiles[b])
    return y_tiles


def bell2_spmm_tiles_accum(entries, x3d, y_tiles):
    """``Y_tiles += R @ X`` for a sparse accumulating stream and B
    right-hand sides.

    ``x3d``: (B, x_rows, 128) and ``y_tiles``: (B, T, 128) float32 planes,
    each contiguous (any plane stride), T at least ``entries.min_tiles``;
    ``y_tiles`` is added into in place and returned. Other operands and
    the note on non-finite x as :func:`bell2_spmv_tiles_accum`; the entry
    list is read once per group of up to ``_cuda.RHS_GROUP`` planes.
    """
    return _spmm_accum(bell2_spmm_tiles_accum, torch.float32, entries, x3d,
                       y_tiles)


def _spmm_accum(wrapper, dtype, entries, x3d, y_tiles):
    """The body of :func:`bell2_spmm_tiles_accum` for entries of ``dtype``
    values; kernel launches count on ``wrapper`` (the float64 form is
    ``bell2_df.bell2_spmm_tiles_accum_df``)."""
    dev = _device_of(entries.rows, entries.cols, entries.vals)
    _cuda.check_values(entries.vals, "entries.vals", dtype)
    B = _cuda.check_planes(x3d, "x3d", dev, dtype)
    _cuda.check_planes(y_tiles, "y_tiles", dev, dtype, B=B)
    _check_entries(entries, x3d.shape[1], y_tiles.shape[1])
    if dev.type == "cpu":
        return bell2_spmm_tiles_accum_plain(entries, x3d, y_tiles)
    if entries.count:
        _cuda.count(wrapper, entries.vals.dtype, _launch_entries(
            entries, x3d, y_tiles, wrapper.__name__))
    return y_tiles


def sbell_spmm_tiles_plain(vals, packed, meta, step_block, x3d, *,
                           num_row_tiles, chunks_per_step, tiles_per_block,
                           transpose_windows, out=None):
    """Plain PyTorch twin of :func:`sbell_spmm_tiles`: B5's twin once per
    plane."""
    if out is None:
        out = x3d.new_empty((x3d.shape[0],
                             _tiles_padded(num_row_tiles, tiles_per_block),
                             LANES))
    for b in range(x3d.shape[0]):
        sbell_spmv_tiles_plain(vals, packed, meta, step_block, x3d[b],
                               num_row_tiles=num_row_tiles,
                               chunks_per_step=chunks_per_step,
                               tiles_per_block=tiles_per_block,
                               transpose_windows=transpose_windows,
                               out=out[b])
    return out[:, :num_row_tiles]


def sbell_spmm_tiles(vals, packed, meta, step_block, x3d, *,
                     num_row_tiles, chunks_per_step, tiles_per_block,
                     transpose_windows, out=None):
    """Y tiles (B, T, 128) = (L + Lᵀ) X from the paired strict-lower
    stream, for B right-hand sides: ``x3d`` (B, x_rows, 128) planes of x's
    type (float32; float64 for float64 values), each contiguous; the
    output a contiguous (B, ceil(T/BT)*BT, 128) buffer, zeroed whole in
    every plane, then accumulated. Other operands as
    :func:`sbell_spmv_tiles`; launches as :func:`bell2_spmm_tiles`, in
    groups of up to ``_cuda.RHS_GROUP`` planes in every value type.
    """
    K, BT, TW = chunks_per_step, tiles_per_block, transpose_windows
    dev = _device_of(vals, packed, meta, step_block)
    dtype = _cuda.xy_dtype(vals)
    _check_sbell(vals, packed, meta, step_block, K, TW, dtype)
    B = _cuda.check_planes(x3d, "x3d", dev, dtype)
    out = _out_buffer(out, (B, _tiles_padded(num_row_tiles, BT), LANES),
                      dev, dtype)
    if dev.type == "cpu":
        return sbell_spmm_tiles_plain(
            vals, packed, meta, step_block, x3d,
            num_row_tiles=num_row_tiles, chunks_per_step=K,
            tiles_per_block=BT, transpose_windows=TW, out=out,
        )
    _cuda.count(sbell_spmm_tiles, vals.dtype, _launch_sbell(
        vals, packed, meta, step_block, x3d, out, K, BT, TW,
        "sbell_spmm_tiles"), f64_apart=True)
    return out[:, :num_row_tiles]


#: launches of the CUDA kernels through these wrappers (never the twins);
#: an SpMM stream wrapper counts one per group of planes; a stream wrapper
#: counts the launches of its bf16 instances apart, in ``launches_bf16``,
#: and the paired ones those of their double instance in ``launches_f64``;
#: ``bell2_entries_rows`` counts its kernel, not its carry pass (as the
#: stream wrappers count no zero pass)
unperm_gather_tiles.launches = 0
bell2_entries_rows.launches = 0
unperm_gather_tiles_mm.launches = 0
for _w in (bell2_spmv_tiles, bell2_spmv_tiles_accum, sbell_spmv_tiles,
           bell2_spmm_tiles, bell2_spmm_tiles_accum, sbell_spmm_tiles):
    _w.launches = _w.launches_bf16 = 0
sbell_spmv_tiles.launches_f64 = sbell_spmm_tiles.launches_f64 = 0
del _w
