from .mmf import read_mmf, write_mmf  # noqa: F401
