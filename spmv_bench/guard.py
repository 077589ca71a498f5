"""The check that a run loads no JAX and nothing of the JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole: the port, ``cfs_spmv_tpu_torch``, begins with the JAX
package's name, so a prefix test would refuse it.
"""

from __future__ import annotations

import ast
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cfs_spmv_tpu"})
#: the program: a plain reference imports nothing of it
PORT = "cfs_spmv_tpu_torch"


def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def imported(path: str) -> set[str]:
    """The top-level names of the modules that the Python file ``path``
    imports, wherever the statement stands (relative imports left out)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names
