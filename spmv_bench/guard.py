"""The check that a run loads no JAX and nothing of the JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole: the port, ``cfs_spmv_tpu_torch``, begins with the JAX
package's name, so a prefix test would refuse it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cfs_spmv_tpu"})


def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)
