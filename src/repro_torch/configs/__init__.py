"""Architecture configs: ``ArchConfig``, the registry of the ten assigned
architectures, ``get_config`` and ``reduced``."""
from .base import ArchConfig, get_config, load_all, reduced

__all__ = ["ArchConfig", "get_config", "load_all", "reduced"]
