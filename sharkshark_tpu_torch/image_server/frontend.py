"""Cache frontend: the scale-out tier in front of the device backend (the
counterpart of the JAX package's image_server/frontend.py).

Rebuild of reference src/sharkshark/image_server/cache_frontend.py:19-108:
POST /upscale/image computes the sha1 filename, returns a cache hit
immediately, otherwise takes a per-file lock (double-checked after
acquisition), proxies the miss to the backend with ?return_type=file,
stores the bytes, and returns the cache URL. GET /upscale/file/<name>
serves bytes with the CORS header the browser extension needs.

The cache/lock provider is pluggable: RedisImageCache gives the
reference's multi-host behavior; MemoryImageCache + LocalLockRegistry
cover a single host without Redis.  The proxy to the backend is stdlib
urllib (http_util.post_file), where the JAX frontend uses httpx.
"""

from __future__ import annotations

import hashlib
import io
import time

from ..utils import get_logger
from .caches import ImageCache, LocalLockRegistry, MemoryImageCache
from .http_util import Router, bytes_response, json_response, post_file

__all__ = ["CacheFrontend", "create_app"]

log = get_logger("image_server.frontend")


def get_filename(buffer: bytes) -> str:
    return hashlib.sha1(buffer).hexdigest() + ".png"


class CacheFrontend:
    def __init__(
        self,
        backend_url: str = "http://127.0.0.1:8087/upscale/image",
        cache: ImageCache | None = None,
        lock_registry=None,
        request_timeout: float = 100.0,
    ):
        self.backend_url = backend_url
        self.cache = cache or MemoryImageCache()
        self.locks = lock_registry or (
            self.cache if hasattr(self.cache, "file_lock") else LocalLockRegistry()
        )
        self.request_timeout = request_timeout
        self.app = self._build_router()

    def _proxy_upscale(self, lr_buffer: bytes) -> tuple[bytes | None, str]:
        try:
            status, body = post_file(
                self.backend_url,
                lr_buffer,
                params={"return_type": "file"},
                timeout=self.request_timeout,
            )
        except TimeoutError:
            return None, "timeout request upscale/image"
        except ConnectionError:
            return None, "gpu server dead?"
        if status != 200:
            return None, body.decode(errors="replace")
        return body, ""

    def _build_router(self) -> Router:
        router = Router()
        fe = self

        @router.route("/upscale/image", "POST")
        def upscale_image(req, start_response):
            lr_buffer = req.file("file")
            if not lr_buffer:
                return json_response(
                    start_response,
                    {"result": "err", "err": "no file uploaded"},
                    "500 Internal Server Error",
                )
            filename = get_filename(lr_buffer)

            if fe.cache.has_file(filename):
                return json_response(
                    start_response,
                    {"result": "ok", "cache": "hit",
                     "url": f"/upscale/file/{filename}"},
                )

            lock = fe.locks.file_lock(filename, timeout=120, blocking_timeout=10)
            acquired = bool(lock.acquire(blocking=True))
            if not acquired:
                # another request holds the single-flight lock past our
                # blocking_timeout; wait for ITS result instead of
                # proxying a duplicate multi-second upscale to the
                # backend (the dedup the lock exists for)
                deadline = time.time() + 110
                while time.time() < deadline:
                    if fe.cache.has_file(filename):
                        return json_response(
                            start_response,
                            {"result": "ok", "cache": "hit",
                             "url": f"/upscale/file/{filename}"},
                        )
                    time.sleep(0.25)
                return json_response(
                    start_response,
                    {"result": "err", "err": "upscale lock timeout"},
                    "504 Gateway Timeout",
                )
            try:
                # double-check: someone may have filled it while we waited
                if fe.cache.has_file(filename):
                    return json_response(
                        start_response,
                        {"result": "ok", "cache": "hit",
                         "url": f"/upscale/file/{filename}"},
                    )
                hr_buffer, err = fe._proxy_upscale(lr_buffer)
                if hr_buffer is None:
                    return json_response(
                        start_response,
                        {"result": "err", "err": err},
                        "500 Internal Server Error",
                    )
                fe.cache.write_file(filename, io.BytesIO(hr_buffer))
                return json_response(
                    start_response,
                    {"result": "ok", "cache": "miss",
                     "url": f"/upscale/file/{filename}"},
                )
            finally:
                if acquired:
                    lock.release()

        @router.route("/upscale/file/<filename>")
        def download_file(req, start_response, filename):
            buf = fe.cache.read_file(filename)
            if buf is None:
                return json_response(
                    start_response,
                    {"result": "err", "err": "not found"},
                    "404 Not Found",
                )
            return bytes_response(
                start_response,
                buf.getvalue(),
                "image/png",
                headers=[("Access-Control-Allow-Origin", "*")],
            )

        @router.route("/upscale/ping")
        def ping(req, start_response):
            return bytes_response(start_response, b"pong", "text/plain")

        return router


def create_app(**kwargs):
    return CacheFrontend(**kwargs).app


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.image_server.frontend")
    p.add_argument("--port", type=int, default=8086)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--backend", default="http://127.0.0.1:8087/upscale/image")
    p.add_argument("--redis-host", default=None,
                   help="use Redis at this host for cache+locks")
    args = p.parse_args(argv)

    cache = None
    if args.redis_host:
        from .caches import RedisImageCache

        cache = RedisImageCache(host=args.redis_host)
    fe = CacheFrontend(backend_url=args.backend, cache=cache)
    from .http_util import serve

    log.info("cache frontend on %s:%d -> %s", args.host, args.port, args.backend)
    serve(fe.app, args.port, args.host)


if __name__ == "__main__":
    main()
