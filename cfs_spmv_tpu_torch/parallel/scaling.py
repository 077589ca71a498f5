"""Weak/strong-scaling model for the distributed SpMV (BASELINE config 5).

Port of ``cfs_spmv_tpu/parallel/scaling.py``: the same model with link
tables for NVIDIA H100 nodes. A run here has one card, so an N-card claim
is stated as a *measured single-card stream rate* + *modeled
communication*, not asserted. The model follows the design's
communication structure (``parallel/dist.py``):

- the paired/SDIA near streams read only the device's own x segment —
  zero interconnect traffic;
- the far stream needs remote x: ``comm="halo"`` moves 2*H boundary rows
  per device, ``comm="gather"`` the whole x, and ``comm="ring"`` rotates
  the local segment ``ndev-1`` times, each hop overlapped with the far
  sub-stream compute against the segment that just arrived.

Each hop inside a node rides NVLink; once the ring spans more than one
node every hop costs the inter-node link's time instead (the ring
crosses every node boundary once per hop). Far nonzeros are charged at
the far-stream rate (default: half the near rate), and each ring step
at a per-step launch floor (``STEP_OVERHEAD_S``, kept from the
reference until a card measures it).

Per-device time under overlap is
``t_near + (ndev-1) * max(t_hop_comm, t_far_step)`` and weak-scaling
efficiency is the single-device time over that. Strong scaling divides
this matrix instead of replicating it: efficiency =
``t_1 / (ndev * t_dev)``.

The link rates are data-sheet figures, not measurements: NVLink 4 at
900 GB/s per GPU (NVIDIA H100 SXM data sheet; 600 GB/s NVLink bridge on
the PCIe and NVL parts) inside a node of 8 GPUs (HGX H100), and
InfiniBand NDR at 400 Gb/s = 50 GB/s per GPU between nodes (DGX H100:
one ConnectX-7 per GPU). The ``cpu`` row is the reference's, for meshes
without a card. Override with ``ici_bytes_s`` (the link inside a node) /
``dcn_bytes_s`` (between nodes) if yours differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csr import CSR
from ..tuning.partition import partition_tiles_by_nnz, tile_nnz_histogram

__all__ = [
    "far_profile",
    "FarProfile",
    "scaling_model",
    "weak_scaling_model",
]

LANES = 128

#: per-GPU link rate inside a node (bytes/s), by ``roofline.detect_chip``
#: name: NVLink 4 (data sheets); "cpu" is the reference's row
ICI_BW = {
    "h100-sxm": 9.0e11,
    "h100-pcie": 6.0e11,
    "h100-nvl": 6.0e11,
    "cpu": 5e9,
}

#: per-GPU link rate between nodes (bytes/s): InfiniBand NDR, one 400 Gb/s
#: ConnectX-7 per GPU (DGX H100); the ring crosses each node boundary with
#: one segment per hop, so this is the per-hop inter-node rate
DCN_BW = {
    "h100-sxm": 5.0e10,
    "h100-pcie": 5.0e10,
    "h100-nvl": 5.0e10,
    "cpu": 1e9,
}

#: GPUs per node (the NVLink domain)
CHIPS_PER_HOST = {"h100-sxm": 8, "h100-pcie": 8, "h100-nvl": 8, "cpu": 8}

#: the link names ``scaling_model`` reports, inside and between nodes
LINK_NAMES = {"cpu": ("ici", "dcn")}
_GPU_LINKS = ("nvlink", "infiniband")

#: the chip a name not in the tables is taken for
DEFAULT_CHIP = "h100-sxm"

#: per-ring-step dispatch floor (one far-kernel launch per hop)
STEP_OVERHEAD_S = 5e-6


@dataclasses.dataclass
class FarProfile:
    ndev: int
    far_nnz: int            # nonzeros needing a remote x value
    far_fraction: float
    halo_cols_max: int      # max distinct remote columns on any device
    seg_bytes: int          # one ring hop payload (x segment, 4B values)
    #: halo-window overhang in rows (<= matrix bandwidth, 128-aligned):
    #: what DistSpDMV's comm="halo" neighbor exchange moves per side
    halo_rows: int = 0


def far_profile(csr: CSR, ndev: int) -> FarProfile:
    """Halo volume of the equal-nnz contiguous tile partition at
    ``ndev`` devices — the same partitioner DistSpDMV applies, without
    building any device state."""
    T = max(1, -(-csr.nrows // LANES))
    rowlen = np.diff(csr.indptr)
    row = np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen)
    col = csr.indices.astype(np.int64)
    hist = tile_nnz_histogram(csr.indptr, T)
    if csr.symmetric:
        hist = hist + np.bincount(col >> 7, minlength=T)
    bounds = partition_tiles_by_nnz(hist, ndev)
    ends = np.minimum(bounds[1:] * LANES, csr.nrows)
    ro = np.searchsorted(ends, row, side="right")
    co = np.searchsorted(ends, col, side="right")
    cross = ro != co
    far = int(np.count_nonzero(cross)) * (2 if csr.symmetric else 1)
    nnz_full = (
        2 * csr.nnz if csr.symmetric else csr.nnz
    )  # diagonal miscount is negligible for the model
    halo_max = 0
    if cross.any():
        # distinct (owner device, remote column) pairs per device
        key = ro[cross] * (csr.ncols + 1) + col[cross]
        if csr.symmetric:
            key = np.concatenate(
                [key, co[cross] * (csr.ncols + 1) + row[cross]]
            )
        uniq = np.unique(key)
        cnt = np.bincount(uniq // (csr.ncols + 1), minlength=ndev)
        halo_max = int(cnt.max())
    seg_rows = int(np.max(np.diff(np.concatenate([[0], ends]))))
    bw = int(np.abs(col - row).max()) if len(row) else 0
    halo_rows = -(-bw // LANES) * LANES
    return FarProfile(
        ndev, far, far / max(nnz_full, 1), halo_max, 4 * seg_rows,
        halo_rows,
    )


def scaling_model(
    csr: CSR,
    *,
    measured_nnz_s: float,
    far_nnz_s: float | None = None,
    mode: str = "weak",
    comm: str = "auto",
    ndevs=(2, 4, 8, 16, 32),
    chip: str = DEFAULT_CHIP,
    ici_bytes_s: float | None = None,
    dcn_bytes_s: float | None = None,
    chips_per_host: int | None = None,
    step_overhead_s: float = STEP_OVERHEAD_S,
    profiles: dict | None = None,
):
    """Modeled weak- or strong-scaling efficiency over ``ndevs``.

    ``measured_nnz_s`` is the measured single-card rate on this matrix;
    ``far_nnz_s`` the far (one-sided halo) stream's rate — defaults to
    half the near rate, the reference's default (not measured on the
    card). Weak scaling replicates this matrix's per-device
    workload (global size grows with ``ndev``); strong scaling divides
    THIS matrix.

    ``comm`` mirrors DistSpDMV: "auto" = the neighbor halo exchange
    when the window fits one segment (2*halo_rows*4 B per device,
    independent of device count — charged unoverlapped), else a full-x
    gather ((ndev-1) segment hops); "ring" = ndev-1 rotations, each
    overlapping its far sub-stream. Hops cross the node's link (NVLink
    on an H100 node) inside a node and the inter-node link (InfiniBand)
    between nodes; ``link`` in each row names the one used.

    Returns a list of dicts (one per device count).
    """
    if chip not in ICI_BW:
        chip = DEFAULT_CHIP
    ici = ici_bytes_s or ICI_BW[chip]
    dcn = dcn_bytes_s or DCN_BW[chip]
    cph = chips_per_host or CHIPS_PER_HOST[chip]
    intra, inter = LINK_NAMES.get(chip, _GPU_LINKS)
    fr = far_nnz_s or 0.5 * measured_nnz_s
    nnz_full = 2 * csr.nnz if csr.symmetric else csr.nnz
    t1 = nnz_full / max(measured_nnz_s, 1.0)
    rows = []
    for nd in ndevs:
        if profiles is not None and nd in profiles:
            prof = profiles[nd]
        else:
            prof = far_profile(csr, nd)
            if profiles is not None:
                profiles[nd] = prof
        fd = prof.far_fraction
        hosts = -(-nd // cph)
        if mode == "weak":
            # every device holds a shard shaped like THIS matrix; the
            # far fraction at nd cuts applies to a nd-times bigger
            # global problem, so per-device far work = fd * nnz_full
            seg_bytes = 4 * csr.nrows
            t_near = (1 - fd) * nnz_full / measured_nnz_s
            t_far = fd * nnz_full / fr
        else:
            # THIS matrix split nd ways
            seg_bytes = 4 * (-(-csr.nrows // nd))
            t_near = (1 - fd) * nnz_full / measured_nnz_s / nd
            t_far = fd * nnz_full / fr / nd
        link = dcn if hosts > 1 else ici
        seg_rows = seg_bytes // 4
        # 'halo' mirrors DistSpDMV's explicit request (falls back to
        # gather when the window cannot fit a segment, like the impl)
        use_halo = (
            comm in ("auto", "halo") and prof.halo_rows <= seg_rows
        )
        if comm != "ring" and use_halo:
            # neighbor exchange: 2*H rows once, unoverlapped (upper
            # bound); far compute runs after
            t_comm = 2 * prof.halo_rows * 4 / link + step_overhead_s
            t_dev = t_near + t_far + t_comm
            used = "halo"
        elif comm != "ring":
            # full-x gather: every device receives (nd-1) segments
            t_comm = (nd - 1) * seg_bytes / link + step_overhead_s
            t_dev = t_near + t_far + t_comm
            used = "gather"
        else:
            hop_link = seg_bytes / link
            t_hop = (
                max(hop_link, t_far / max(nd - 1, 1)) + step_overhead_s
            )
            t_dev = t_near + (nd - 1) * t_hop
            t_comm = (nd - 1) * hop_link
            used = "ring"
        if mode == "weak":
            eff = t1 / max(t_dev, 1e-30)
        else:
            eff = t1 / max(nd * t_dev, 1e-30)
        rows.append(
            dict(
                ndev=nd,
                hosts=hosts,
                far_fraction=fd,
                halo_cols_max=prof.halo_cols_max,
                halo_rows=prof.halo_rows,
                comm=used,
                comm_bytes=int(
                    2 * prof.halo_rows * 4 if used == "halo"
                    else (nd - 1) * seg_bytes
                ),
                link=inter if hosts > 1 else intra,
                t_compute_s=t_near + t_far,
                t_comm_s=t_comm,
                t_dev_s=t_dev,
                efficiency=min(eff, 1.0),
            )
        )
    return rows


def weak_scaling_model(
    csr: CSR,
    *,
    measured_nnz_s: float,
    ndevs=(2, 4, 8, 16),
    chip: str = DEFAULT_CHIP,
    ici_bytes_s: float | None = None,
):
    """Backward-compatible wrapper over ``scaling_model(mode="weak")``."""
    return scaling_model(
        csr, measured_nnz_s=measured_nnz_s, ndevs=ndevs, chip=chip,
        ici_bytes_s=ici_bytes_s, mode="weak",
    )
