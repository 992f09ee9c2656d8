"""Environment helpers: optional-dependency gating and misc formatting
(a copy of the JAX package's utils/env.py, which imports no JAX).

Every host-side integration (ffmpeg, redis, PyAV, ...) is optional and
gated through `has_module` / `has_binary` (reference counterpart: hard
imports in src/stream/*).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import shutil
from functools import lru_cache

__all__ = ["has_module", "require_module", "has_binary", "stream_credentials", "human_readable"]


@lru_cache(maxsize=None)
def has_module(name: str) -> bool:
    """True if `name` is importable without importing it."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def require_module(name: str, hint: str = ""):
    if not has_module(name):
        raise ImportError(
            f"optional dependency '{name}' is not installed. {hint}".strip()
        )
    return importlib.import_module(name)


@lru_cache(maxsize=None)
def has_binary(name: str) -> bool:
    """True if an executable `name` is on PATH (e.g. ffmpeg)."""
    return shutil.which(name) is not None


def stream_credentials() -> dict:
    """Twitch credentials from the environment (replaces the reference's
    gitignored src/util/env_var.py secrets module, env_var.example.py:1-3)."""
    return {
        "stream_key": os.environ.get("SHARKSHARK_TWITCH_STREAMKEY", ""),
        "oauth": os.environ.get("SHARKSHARK_TWITCH_OAUTH", ""),
        "username": os.environ.get("SHARKSHARK_TWITCH_USERNAME", ""),
    }


def human_readable(byte_count: int) -> str:
    """Format a byte count, e.g. 1536 -> '1.5KB'.

    Reference counterpart: src/util/__init__.py:1-8.
    """
    size = float(byte_count)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(size) < 1024.0 or unit == "TB":
            return f"{size:.1f}{unit}" if unit != "B" else f"{int(size)}B"
        size /= 1024.0
    return f"{size:.1f}TB"
