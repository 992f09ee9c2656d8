"""Image byte caches for the upscale HTTP service (a copy of the JAX
package's image_server/caches.py, which imports no JAX).

Rebuild of reference src/sharkshark/image_server/{image_cache,
stateful_cache, stateless_cache}.py:

- ReaderWriterObject — readers-writer lock wrapper (image_cache.py:15-50)
- MemoryImageCache   — LRU dict of BytesIO with RW locking
  (stateful_cache.py:168-228)
- DiskImageCache     — filelock-claimed per-process storage dir with LRU
  eviction to a byte budget (stateful_cache.py:17-165)
- RedisImageCache    — byte cache + per-file distributed locks
  (stateless_cache.py:11-34); import-gated since redis-py is optional
- LocalLockRegistry  — in-process per-file locks with timeouts, the
  single-host stand-in for Redis locks used by the cache frontend.

All caches share the ImageCache interface: has_file -> url | None,
read_file -> BytesIO | None, write_file(filename, BytesIO) -> url.
"""

from __future__ import annotations

import io
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..utils import get_logger, human_readable

__all__ = [
    "ImageCache",
    "ReaderWriterObject",
    "MemoryImageCache",
    "DiskImageCache",
    "RedisImageCache",
    "LocalLockRegistry",
]

log = get_logger("image_server.caches")


class ImageCache:
    def has_file(self, filename: str) -> Optional[str]:
        raise NotImplementedError

    def read_file(self, filename: str) -> Optional[io.BytesIO]:
        raise NotImplementedError

    def write_file(self, filename: str, buffer: io.BytesIO) -> str:
        raise NotImplementedError

    @staticmethod
    def url_for(filename: str) -> str:
        return f"/upscale/file/{filename}"


class ReaderWriterObject:
    """Readers-writer lock around a value (writer-preferring)."""

    def __init__(self, value):
        self.value = value
        self._lock = threading.Lock()
        self._readers_ok = threading.Condition(self._lock)
        self._writers_ok = threading.Condition(self._lock)
        self._readers = 0
        self._writers = 0
        self._writers_waiting = 0

    def get(self):
        return self.value

    @contextmanager
    def read(self):
        with self._lock:
            while self._writers or self._writers_waiting:
                self._readers_ok.wait()
            self._readers += 1
        try:
            yield self.value
        finally:
            with self._lock:
                self._readers -= 1
                if self._readers == 0:
                    self._writers_ok.notify()

    @contextmanager
    def write(self):
        with self._lock:
            self._writers_waiting += 1
            while self._readers or self._writers:
                self._writers_ok.wait()
            self._writers_waiting -= 1
            self._writers = 1
        try:
            yield self.value
        finally:
            with self._lock:
                self._writers = 0
                self._writers_ok.notify()
                self._readers_ok.notify_all()


class MemoryImageCache(ImageCache):
    def __init__(self, max_size: int = 1024 * 1024 * 1024):
        self.max_size = max_size
        self.size = 0
        self._table = ReaderWriterObject({})  # filename -> (bytes, last_used)

    def has_file(self, filename: str) -> Optional[str]:
        with self._table.read() as t:
            if filename not in t:
                return None
        with self._table.write() as t:
            if filename in t:
                t[filename] = (t[filename][0], time.time())
                return self.url_for(filename)
        return None

    def read_file(self, filename: str) -> Optional[io.BytesIO]:
        with self._table.write() as t:
            if filename not in t:
                return None
            data, _ = t[filename]
            t[filename] = (data, time.time())
            return io.BytesIO(data)

    def write_file(self, filename: str, buffer: io.BytesIO) -> str:
        data = buffer.getvalue()
        with self._table.write() as t:
            if filename in t:
                self.size -= len(t[filename][0])
            t[filename] = (data, time.time())
            self.size += len(data)
            while self.size > self.max_size and len(t) > 1:
                lru = min(t.items(), key=lambda kv: kv[1][1])[0]
                self.size -= len(t[lru][0])
                del t[lru]
        return self.url_for(filename)


class DiskImageCache(ImageCache):
    def __init__(self, root: str = "./cache", max_size: int = 2 * 1024**3):
        import filelock

        os.makedirs(root, exist_ok=True)
        self.root = root
        # claim a private storage dir: 0.lock, 1.lock, ... first free wins
        self.idx = 0
        while True:
            lock = filelock.FileLock(
                os.path.join(root, f"{self.idx}.lock"), timeout=0.1
            )
            try:
                lock.acquire()
                self._dir_lock = lock
                break
            except filelock.Timeout:
                self.idx += 1
        self.path = os.path.join(root, f"{self.idx}_storage")
        os.makedirs(self.path, exist_ok=True)
        self.max_size = max_size
        self._table = ReaderWriterObject({})  # filename -> last_used
        self.size = 0
        self._load()
        self._evict_to(max_size)

    def _get_path(self, filename: str) -> str:
        return os.path.join(self.path, filename)

    def _load(self) -> None:
        size = 0
        with self._table.write() as t:
            for f in os.listdir(self.path):
                t[f] = time.time()
                try:
                    size += os.path.getsize(self._get_path(f))
                except FileNotFoundError:
                    pass
        self.size = size
        log.info(
            "loaded cache %.2f%% (%s)",
            self.size / self.max_size * 100,
            human_readable(self.size),
        )

    def _evict_to(self, budget: int) -> None:
        if self.size <= budget:
            return
        with self._table.write() as t:
            for f, _ in sorted(t.items(), key=lambda kv: kv[1]):
                if self.size <= budget:
                    break
                p = self._get_path(f)
                try:
                    sz = os.path.getsize(p)
                    os.remove(p)
                    self.size -= sz
                except FileNotFoundError:
                    pass
                del t[f]

    def has_file(self, filename: str) -> Optional[str]:
        if os.path.exists(self._get_path(filename)):
            with self._table.write() as t:
                t[filename] = time.time()
            return self.url_for(filename)
        return None

    def read_file(self, filename: str) -> Optional[io.BytesIO]:
        p = self._get_path(filename)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None
        with self._table.write() as t:
            t[filename] = time.time()
        return io.BytesIO(data)

    def write_file(self, filename: str, buffer: io.BytesIO) -> str:
        data = buffer.getvalue()
        path = self._get_path(filename)
        # size accounting and the file write stay under the table write
        # lock: concurrent handler threads interleaving the unlocked
        # read-modify-writes would drift self.size permanently, breaking
        # LRU eviction in either direction
        with self._table.write() as t:
            try:
                self.size -= os.path.getsize(path)  # overwriting: drop old
            except FileNotFoundError:
                pass
            with open(path, "wb") as f:
                f.write(data)
            t[filename] = time.time()
            self.size += len(data)
        self._evict_to(self.max_size)
        return self.url_for(filename)


class RedisImageCache(ImageCache):
    """Distributed byte cache + per-file locks (requires redis-py and a
    reachable server; reference stateless_cache.py:11-34)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 6379,
        prefix: str = "ss4_",
        client=None,
    ):
        """client: any object with the redis-py get/set/exists/lock
        surface — injectable so multi-frontend coordination is testable
        without a live server (tests/test_image_server.py)."""
        if client is None:
            import redis

            client = redis.Redis(host=host, port=port, db=0)
        self.prefix = prefix
        self.lock_suffix = "_lock"
        self.rd = client

    def file_lock(self, filename: str, timeout: float = 30, blocking_timeout: float = 10):
        return self.rd.lock(
            self.prefix + filename + self.lock_suffix,
            timeout=timeout,
            blocking_timeout=blocking_timeout,
        )

    def has_file(self, filename: str) -> Optional[str]:
        return self.url_for(filename) if self.rd.exists(self.prefix + filename) else None

    def read_file(self, filename: str) -> Optional[io.BytesIO]:
        data = self.rd.get(self.prefix + filename)
        return io.BytesIO(data) if data is not None else None

    def write_file(self, filename: str, buffer: io.BytesIO) -> str:
        self.rd.set(self.prefix + filename, buffer.getvalue())
        return self.url_for(filename)


class LocalLockRegistry:
    """Per-key locks with the redis-lock acquire/release surface, for
    single-host frontends without Redis."""

    def __init__(self):
        self._locks: dict[str, threading.Lock] = {}
        self._guard = threading.Lock()

    class _Handle:
        def __init__(self, lock: threading.Lock, blocking_timeout: float):
            self._lock = lock
            self._timeout = blocking_timeout

        def acquire(self, blocking: bool = True) -> bool:
            return self._lock.acquire(blocking, timeout=self._timeout)

        def release(self) -> None:
            try:
                self._lock.release()
            except RuntimeError:
                pass

        def __enter__(self):
            self.acquire()
            return self

        def __exit__(self, *exc):
            self.release()

    def file_lock(self, key: str, timeout: float = 30, blocking_timeout: float = 10):
        with self._guard:
            lock = self._locks.setdefault(key, threading.Lock())
        return self._Handle(lock, blocking_timeout)
