from .spdmv import SpDMV  # noqa: F401
