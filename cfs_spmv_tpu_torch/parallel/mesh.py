"""Device meshes for the distributed SpMV.

Port of ``cfs_spmv_tpu/parallel/mesh.py``. The reference builds a
``jax.sharding.Mesh`` over its chips (its tests over 8 virtual CPU
devices of one host), global across hosts once
``multihost.initialize()`` has run. Here a :class:`Mesh` is the tuple of
``torch.device``s that hold the row shards, one shard an entry, and
either one process drives it all or each process holds one shard:

- one process (no process group initialized): one device may appear
  several times: ``make_mesh(4, device="cuda:0")`` puts four shards on
  one card (and ``device="cpu"`` four on the CPU), the counterpart of the
  reference's virtual devices; ``make_mesh(device="cuda")`` puts one
  shard on each of the node's cards. ``CFS_NUM_DEVICES`` mirrors the
  reference's (0 = all);
- one process per shard (after ``multihost.initialize()``, the
  counterpart of the reference's global mesh): ``make_mesh()`` gives one
  row shard per rank of the default (world) process group; the mesh
  knows the group and its own ``rank``, and this process's device
  (``cuda:LOCAL_RANK``, or the CPU) stands for every shard in
  ``devices``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.spmv import as_device
from ..utils.config import config

__all__ = ["Mesh", "get_devices", "make_mesh", "ROWS_AXIS", "RHS_AXIS"]

#: mesh axis sharding matrix rows (the analog of the reference's
#: per-thread row ranges, csr_matrix.tpp:403-541)
ROWS_AXIS = "rows"
#: mesh axis sharding SpMM right-hand sides (data-parallel analog)
RHS_AXIS = "rhs"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D row mesh, or of a 2-D (rows, rhs) mesh laid
    out row-major with ``rhs`` innermost."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (ROWS_AXIS,)
    #: devices along the rhs axis (1 on a row mesh)
    rhs: int = 1
    #: the process group of a mesh of one process per shard (the default
    #: group; shard d is its rank d), None where one process drives it
    group: object = None
    #: this process's shard on a process-group mesh
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        """Devices along each axis, as ``jax.sharding.Mesh.shape``."""
        out = {ROWS_AXIS: len(self.devices) // self.rhs}
        if RHS_AXIS in self.axis_names:
            out[RHS_AXIS] = self.rhs
        return out

    @property
    def row_devices(self) -> tuple[torch.device, ...]:
        """The device of each row shard: the first of its ``rhs`` group."""
        return self.devices[:: self.rhs]

    @property
    def single_device(self) -> bool:
        """Every shard on one device of this process (never on a
        process-group mesh)."""
        return self.group is None and len(set(self.devices)) == 1


def get_devices(num: int | None = None, device="cuda"):
    """Devices to use; honors CFS_NUM_DEVICES (0 = all).

    ``"cuda"`` means the node's cards, one shard each (a request for more
    cards than there are raises ``ValueError``); a device with an index
    (``"cuda:0"``) or ``"cpu"`` means ``num`` shards (default
    ``CFS_NUM_DEVICES``, else 1) on that one device. ``"cuda"`` raises
    where CUDA is absent, as every entry point of the port does.
    """
    dev = as_device(device)
    want = num if num is not None else config.num_devices
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if want and want > 0:
            if want > len(devs):
                raise ValueError(
                    f"requested {want} devices, only {len(devs)} available"
                )
            devs = devs[:want]
        return devs
    return [dev] * (want if want and want > 0 else 1)


def make_mesh(num: int | None = None, *, rhs: int = 1, device="cuda") -> Mesh:
    """1D row mesh, or 2D (rows, rhs) when ``rhs > 1``.

    Axis order puts ``rhs`` innermost, as in the reference. Where a
    process group is initialized (``multihost.initialize()``), one row
    shard per rank of the default group, on this process's ``device``
    (``"cuda"``: the current card, which ``initialize`` set to
    ``cuda:LOCAL_RANK``); ``num``, if given, must be the world size.
    """
    if dist.is_available() and dist.is_initialized():
        return _process_mesh(num, rhs, device)
    devs = tuple(get_devices(num, device))
    n = len(devs)
    if rhs > 1:
        if n % rhs:
            raise ValueError(f"{n} devices not divisible by rhs={rhs}")
        return Mesh(devs, (ROWS_AXIS, RHS_AXIS), rhs)
    return Mesh(devs)


def _process_mesh(num, rhs, device) -> Mesh:
    """The row mesh of one shard per rank of the default process group."""
    P, rank = dist.get_world_size(), dist.get_rank()
    if rhs > 1:
        raise NotImplementedError(
            "a (rows, rhs) mesh over processes is not ported: one row shard "
            "a rank")
    if num is not None and num != P:
        raise ValueError(f"a process-group mesh has one shard a rank: "
                         f"{P}, not {num}")
    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((dev,) * P, group=dist.group.WORLD, rank=rank)
