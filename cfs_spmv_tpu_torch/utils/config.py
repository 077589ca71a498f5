"""Runtime configuration.

Host copy of ``cfs_spmv_tpu/utils/config.py`` for the PyTorch port. Only
the knobs that mean something on the port's path remain; env vars keep
the ``CFS_`` prefix. The planner's own knobs (``CFS_PAIRED``,
``CFS_SDIA_SYM_ROWS_MAX``, ``CFS_NATIVE``) are read where they are used,
exactly as in the reference.
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

    # --- runtime ---
    #: verbose [INFO] logging (runtime flag replacing compile-time
    #: _LOG_INFO, ref configure.ac:64-67)
    log_info: bool = dataclasses.field(
        default_factory=lambda: env_flag("CFS_LOG", False)
    )


#: process-global config instance (mutable; tests may override fields)
config = Config()
