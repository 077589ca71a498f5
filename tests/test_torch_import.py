"""The PyTorch port imports without JAX and without Triton, and its
package surface is the reference's.

The card's machine has no JAX, so importing ``cfs_spmv_tpu_torch`` or any
of its submodules must never pull in ``jax`` (nor ``triton``, which the
port does not use, nor ``ml_dtypes``). Checked in a fresh interpreter,
since this test process has JAX loaded through the reference's tests. The
tolerance of a 2-byte type is read there too: numpy knows ``bfloat16`` by
name only after ``ml_dtypes`` is imported, which JAX does and the port
does not; and a bfloat16 plan is tuned, saved to a plan cache and loaded
back there without it.

The port's top-level names are the reference's, and it has a counterpart
of every module of the reference (``ABSENT_MODULES``, the modules still to
port, is empty).
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
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "cfs_spmv_tpu",
                                    "ml_dtypes"))
print(len(names), bad)
assert len(names) >= 28, names
for new in ("ops.sdia_df", "ops.bell2_df", "ops.xla_ref", "models.solvers",
            "utils.timing", "utils.roofline", "utils.trace",
            "cli.bench_spmv_mmf", "io.plancache", "parallel.dist",
            "parallel.mesh", "parallel.scaling", "parallel.multihost",
            "tuning.partition", "tuning.cluster", "cli.bench_dist"):
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


_TOLERANCE_PROBE = """
import sys
import numpy as np
from cfs_spmv_tpu_torch.utils.platform import rel_tolerance
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print(rel_tolerance(np.float16), rel_tolerance(np.float32),
      rel_tolerance(np.float64))
assert rel_tolerance(np.float16) == 5e-2
assert rel_tolerance(np.dtype("int16")) == 5e-2
try:
    rel_tolerance(np.int32)
except ValueError:
    pass
else:
    raise AssertionError("a 4-byte integer has no tolerance")
"""


def test_two_byte_tolerance_without_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _TOLERANCE_PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


_PLANCACHE_PROBE = """
import os, sys, tempfile
import numpy as np
import torch
from cfs_spmv_tpu_torch import COO, CSR, Format
from cfs_spmv_tpu_torch.tuning.tune import tune
csr = CSR.from_coo(COO.random(600, 600, 4.0, symmetric=True, bandwidth=30,
                              seed=3, dtype=np.float64))
d = tempfile.mkdtemp()
x = torch.ones(600)
t1 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d, device="cpu")
t2 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d, device="cpu")
assert len(os.listdir(d)) == 1
assert t2.plan.far.vals.dtype == np.uint16
assert torch.equal(t1.matvec(x), t2.matvec(x))
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print("ok")
"""


def test_bf16_plan_cache_without_ml_dtypes():
    """A bfloat16 plan goes through the plan cache (saved, then loaded)
    in a process that never imports ``ml_dtypes``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _PLANCACHE_PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


#: modules of the reference (paths under its package) with no counterpart
#: in the port yet: none
ABSENT_MODULES: set[str] = set()


def _modules(package):
    top = os.path.join(ROOT, package)
    return {
        os.path.relpath(os.path.join(d, f), top).replace(os.sep, "/")
        for d, _, files in os.walk(top) for f in files if f.endswith(".py")
    }


def test_package_surface_is_the_reference_s():
    import cfs_spmv_tpu as ref
    import cfs_spmv_tpu_torch as port

    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
    # the enums the two packages share have the same members; Platform
    # names the port's own devices
    for enum in ("Format", "Kernel", "Tuning"):
        assert ([m.name for m in getattr(port, enum)]
                == [m.name for m in getattr(ref, enum)])
    assert {m.value for m in port.Platform} == {"cuda", "cpu"}
    assert port.is_equal([1.0, 2.0], [1.0, 2.0 + 1e-6], "float32")
    assert not port.is_equal([1.0, 2.0], [1.0, 2.1], "float32")
    assert "float64" in port.__doc__
    absent = _modules("cfs_spmv_tpu") - _modules("cfs_spmv_tpu_torch")
    assert absent == ABSENT_MODULES, sorted(absent ^ ABSENT_MODULES)
