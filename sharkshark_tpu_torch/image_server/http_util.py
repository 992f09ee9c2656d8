"""Minimal WSGI micro-framework for the image service (a copy of the JAX
package's image_server/http_util.py, with a stdlib HTTP client added).

The reference uses Flask (backend) and FastAPI+uvicorn (frontend); the
service surface is four routes, so this provides just enough: a route
table with path params, JSON/bytes responses, multipart/form-data file
extraction, and a threaded stdlib server (the reference runs gunicorn
with 1 worker x 256 threads, which a ThreadingWSGIServer matches on a
single host).  The client side, `multipart_body` and `post_file`, is
urllib only: the cache frontend's proxy and the load test use it, so
the service needs no HTTP package beyond the standard library.  The
servers log each request at DEBUG level through the package logger.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
import uuid
from email.parser import BytesParser
from email.policy import HTTP
from socketserver import ThreadingMixIn
from typing import Callable
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from ..utils import get_logger

__all__ = [
    "Router", "Request", "json_response", "bytes_response", "serve", "serve_background",
    "ThreadedWSGIServer", "multipart_body", "post_file",
]

log = get_logger("image_server.http")


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ.get("PATH_INFO", "/")
        self.query = {}
        for pair in environ.get("QUERY_STRING", "").split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                self.query[k] = v
        self._body: bytes | None = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
            self._body = self.environ["wsgi.input"].read(length)
        return self._body

    def file(self, name: str = "file") -> bytes | None:
        """Extract an uploaded file from multipart/form-data (or return the
        raw body for direct uploads)."""
        ctype = self.environ.get("CONTENT_TYPE", "")
        if not ctype.startswith("multipart/form-data"):
            return self.body or None
        # parse with the stdlib email machinery (cgi was removed in 3.13)
        headers = f"Content-Type: {ctype}\r\n\r\n".encode()
        msg = BytesParser(policy=HTTP).parsebytes(headers + self.body)
        for part in msg.iter_parts():
            disp = part.get("Content-Disposition", "")
            if f'name="{name}"' in disp:
                return part.get_payload(decode=True)
        return None


def json_response(start_response, payload: dict, status: str = "200 OK", headers=()):
    data = json.dumps(payload).encode()
    start_response(
        status,
        [("Content-Type", "application/json"), ("Content-Length", str(len(data)))]
        + list(headers),
    )
    return [data]


def bytes_response(
    start_response,
    data: bytes,
    content_type: str = "application/octet-stream",
    status: str = "200 OK",
    headers=(),
):
    start_response(
        status,
        [("Content-Type", content_type), ("Content-Length", str(len(data)))]
        + list(headers),
    )
    return [data]


class Router:
    """Tiny WSGI app: @router.route('/upscale/file/<filename>', 'GET')."""

    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Callable]] = []

    def route(self, pattern: str, method: str = "GET"):
        regex = re.compile(
            "^" + re.sub(r"<(\w+)>", r"(?P<\1>[^/]+)", pattern) + "$"
        )

        def deco(fn):
            self.routes.append((method, regex, fn))
            return fn

        return deco

    def __call__(self, environ, start_response):
        req = Request(environ)
        for method, regex, fn in self.routes:
            if method != req.method:
                continue
            m = regex.match(req.path)
            if m:
                try:
                    return fn(req, start_response, **m.groupdict())
                except Exception as ex:  # noqa: BLE001 — 500 boundary
                    log.exception("%s %s failed", req.method, req.path)
                    return json_response(
                        start_response,
                        {"result": "err", "err": repr(ex)},
                        "500 Internal Server Error",
                    )
        return json_response(
            start_response, {"result": "err", "err": "not found"}, "404 Not Found"
        )


class ThreadedWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # the listen backlog (socketserver's default is 5): past it the kernel
    # drops connection attempts, which clients retry after a second, so a
    # burst of a few dozen concurrent uploads would wait 1 s each (the
    # reference's gunicorn listens with a backlog of 2048)
    request_queue_size = 1024


class _Handler(WSGIRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 — the base class's name
        log.debug("%s %s", self.address_string(), format % args)


def serve(app, port: int, host: str = "0.0.0.0"):
    """Run a threaded WSGI server (blocking)."""
    httpd = make_server(host, port, app, server_class=ThreadedWSGIServer, handler_class=_Handler)
    httpd.serve_forever()


def serve_background(app, port: int, host: str = "127.0.0.1"):
    """Start a threaded WSGI server on a daemon thread and return it
    (port 0 picks a free port: read `server_address`; stop it with
    `shutdown()` and `server_close()`)."""
    httpd = make_server(host, port, app, server_class=ThreadedWSGIServer, handler_class=_Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


# -- client ----------------------------------------------------------------


def multipart_body(data: bytes) -> tuple[bytes, str]:
    """(body, Content-Type) of a multipart/form-data request that uploads
    `data` as the field 'file', the one the service reads."""
    boundary = uuid.uuid4().hex
    head = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="file"; filename="file"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode()
    return head + data + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def post_file(url: str, data: bytes, params: dict | None = None, timeout: float = 100.0) -> tuple[int, bytes]:
    """POST `data` as a multipart file upload; returns (status, body) for
    any HTTP status.  Raises TimeoutError when the server does not answer
    within `timeout` and ConnectionError when it cannot be reached."""
    if params:
        url = f"{url}?{urllib.parse.urlencode(params)}"
    body, ctype = multipart_body(data)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as ex:
        with ex:
            return ex.code, ex.read()
    except urllib.error.URLError as ex:
        if isinstance(ex.reason, TimeoutError):
            raise TimeoutError(f"{url}: {ex.reason}") from ex
        raise ConnectionError(f"{url}: {ex.reason}") from ex
