from .device import resolve_device
from .env import has_module, human_readable, require_module
from .logging import get_logger

__all__ = ["has_module", "require_module", "human_readable", "get_logger", "resolve_device"]
