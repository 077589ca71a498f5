"""Multi-process initialization of the distributed SpMV.

Port of ``cfs_spmv_tpu/parallel/multihost.py``. The reference bootstraps
one program per TPU host with ``jax.distributed``; here one process runs
per card, under a launcher, and ``torch.distributed`` joins them (NCCL on
the cards, gloo on the CPU):

    torchrun --nproc-per-node 4 prog.py

    from cfs_spmv_tpu_torch.parallel import mesh, multihost
    from cfs_spmv_tpu_torch.parallel.dist import DistSpDMV
    multihost.initialize()              # init_process_group, cuda:LOCAL_RANK
    m = mesh.make_mesh()                # one row shard per rank
    dsp = DistSpDMV(csr, m)             # identical plan on every rank
    y = dsp(x)                          # the global x in, the global y out

Every rank makes the same host decisions and plans, uploads only its own
shard, and all-gathers y over the process group (``parallel/dist.py``).
A single process needs no initialization: ``initialize()`` is then a
no-op, as in the reference.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..ops.spmv import as_device
from ..utils.logging import info

__all__ = ["initialize", "is_multiprocess"]


def is_multiprocess() -> bool:
    """True when launched as one of several processes: the launcher's
    (torchrun's) ``WORLD_SIZE`` above 1."""
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return False


def initialize(device="cuda", **kwargs) -> None:
    """Join the process group when running multi-process.

    ``device``: ``"cuda"`` (the default; raises without CUDA, as every
    entry point of the port does) binds this process to
    ``cuda:LOCAL_RANK`` (else its rank modulo the cards) and joins with
    NCCL; ``"cpu"`` joins with gloo. kwargs pass through to
    ``torch.distributed.init_process_group`` (``init_method``, ``rank``,
    ``world_size``; ``backend`` overrides the choice above). A no-op for a
    single process unless kwargs force it, and once the group exists.
    """
    dev = as_device(device)
    if not kwargs and not is_multiprocess():
        info("multihost: single process, skipping torch.distributed")
        return
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
            index = (int(local) if local is not None
                     else rank % torch.cuda.device_count())
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)
    info("multihost: process %d/%d on %s (%s)", dist.get_rank(),
         dist.get_world_size(), dev, kwargs["backend"])
