"""The PyTorch port imports without JAX and without Triton.

The card's machine has no JAX, so importing ``cfs_spmv_tpu_torch`` or any
of its submodules must never pull in ``jax`` (nor ``triton``, which the
port does not use). Checked in a fresh interpreter, since this test
process has JAX loaded through the reference's tests.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import cfs_spmv_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "cfs_spmv_tpu"))
print(len(names), bad)
assert len(names) >= 23, names
for new in ("ops.sdia_df", "ops.bell2_df", "ops.xla_ref"):
    assert "cfs_spmv_tpu_torch." + new in names, new
assert not bad, bad
"""


def test_port_imports_without_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
