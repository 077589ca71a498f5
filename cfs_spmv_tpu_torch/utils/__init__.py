from . import config, logging, platform  # noqa: F401
