"""Runtime configuration.

Host copy of ``cfs_spmv_tpu/utils/config.py`` for the PyTorch port. Only
the knobs that mean something on the port's path remain; env vars keep
the ``CFS_`` prefix. The planner's own knobs (``CFS_PAIRED``,
``CFS_SDIA_SYM_ROWS_MAX``, ``CFS_NATIVE``, ``CFS_DIST_SDIA_ROWS_MAX``) are
read where they are used, exactly as in the reference.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["Config", "config", "env_int", "env_flag"]


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"bad integer for ${name}: {v!r}") from e


def env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    # --- tuning ---
    #: far-stream fraction above which tune() warns that the symmetric
    #: layout is a bad fit (analog of the HYB threshold decision,
    #: ref csr_matrix.tpp:313-401)
    spill_warn_fraction: float = 0.3
    #: float64 execution path (env ``CFS_FP64``): "df" (the default, the
    #: reference's name for its double-float kernels) runs the native
    #: IEEE-fp64 CUDA kernels (``ops/sdia_df.py``, ``ops/bell2_df.py``);
    #: "xla" the plain-PyTorch ELL+COO path (``ops/xla_ref.py``), which
    #: holds no kernel and runs only when asked for by this name. Any
    #: other value makes ``tune(dtype=float64)`` raise.
    fp64_path: str = dataclasses.field(
        default_factory=lambda: os.environ.get("CFS_FP64", "df")
    )
    #: plan cache directory ("" disables): ``tune`` saves each plan it
    #: builds there and loads it again for the same matrix and parameters
    #: (``io/plancache.py``; the reference's files, which it can share)
    plan_cache_dir: str = dataclasses.field(
        default_factory=lambda: os.environ.get("CFS_PLAN_CACHE", "")
    )

    # --- runtime ---
    #: number of devices to use (0 = all); env CFS_NUM_DEVICES mirrors the
    #: reference's CFS_NUM_THREADS (src/runtime.cpp:10-21)
    num_devices: int = dataclasses.field(
        default_factory=lambda: env_int("CFS_NUM_DEVICES", 0)
    )
    #: verbose [INFO] logging (runtime flag replacing compile-time
    #: _LOG_INFO, ref configure.ac:64-67)
    log_info: bool = dataclasses.field(
        default_factory=lambda: env_flag("CFS_LOG", False)
    )


#: process-global config instance (mutable; tests may override fields)
config = Config()
