"""The HTTP image-upscale service: the device-owning backend, the cache
frontend in front of it, the byte caches and the stdlib WSGI layer."""

from .caches import (
    DiskImageCache,
    ImageCache,
    LocalLockRegistry,
    MemoryImageCache,
    ReaderWriterObject,
    RedisImageCache,
)
from .backend import ImageBackend
from .frontend import CacheFrontend
from .http_util import Router, serve, serve_background

__all__ = [
    "DiskImageCache", "ImageCache", "LocalLockRegistry", "MemoryImageCache",
    "ReaderWriterObject", "RedisImageCache",
    "ImageBackend", "CacheFrontend", "Router", "serve", "serve_background",
]
