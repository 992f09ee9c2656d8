"""Image-upscale HTTP backend (the device-owning tier); the counterpart of
the JAX package's image_server/backend.py, with the same request flow.

Rebuild of reference src/sharkshark/image_server/image_pipeline.py:29-393:
POST /upscale/image (multipart 'file', ?return_type=url|file),
GET /upscale/file/<name>, GET /upscale/ping. Flow per request: sha1
content id -> PIL decode with alpha/mono normalization -> pre/post scale
heuristics by pixel count (cap 4096x2048) -> push to the shared upscaler
stage -> block on a per-request event filled by the router thread ->
post-scale, alpha reattach -> PNG (alpha) / progressive JPEG encode.
Worker death (ServiceDeadException) triggers a pipeline rebuild
(reference restart_pipeline, :66-73,295-301).

The upscaler is the port's SR-only EsrganUpscalerService (SRVGG
general-x4v3, its body through the K4 kernel on CUDA), on `device`
("cuda" by default; "cpu" runs the plain PyTorch path).  A worker that
dies while requests wait (a kernel that fails to build or launch) fails
those requests at once with its error; nothing falls back to the CPU.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import queue
import threading
import time

import numpy as np
import torch

from ..runtime import EOF, Profiler, ServiceDeadException
from ..upscale.service import EsrganUpscalerService, UpscalerQueueEntry
from ..utils import get_logger
from .caches import ImageCache, MemoryImageCache
from .http_util import Router, bytes_response, json_response

__all__ = ["ImageBackend", "create_app"]

log = get_logger("image_server.backend")

MAX_PIXELS = 4096 * 2048  # reference :264
# pad request images up to multiples of this: the service coalesces only
# requests of one shape into a dispatch, so buckets let concurrent
# requests of similar sizes share one; 64 keeps the worst-case padding
# overhead < 2x at tiny sizes and ~5 % at typical web-image sizes.  The
# JAX backend pads the same way (to bound its per-shape executables), so
# both return the same pixels at the right and bottom edges.
SHAPE_BUCKET = 64
FORBIDDEN = ("..", "/", "~", "$", "%")


def get_bytes_hash(buffer: bytes) -> str:
    return hashlib.sha1(buffer).hexdigest()


def image_content_type(data: bytes) -> str:
    return "image/jpeg" if data[:2] == b"\xff\xd8" else "image/png"


class ImageBackend:
    """device: where the default upscaler runs ('cuda' in bf16, or 'cpu'
    in float32); weights: a reference-layout SRVGG general-x4v3 .pth for
    it (None: seeded weights, as the JAX backend's random init)."""

    def __init__(
        self,
        upscaler_factory=None,
        cache: ImageCache | None = None,
        use_cache: bool = False,
        job_timeout: float = 20.0,
        device: str = "cuda",
        weights: str | None = None,
    ):
        self.upscaler_factory = upscaler_factory or (
            lambda on_queue: EsrganUpscalerService(
                lr_level=3,
                denoising=False,
                batch_size=1,
                lr_hr_resize=False,
                output_shape=None,
                on_queue=on_queue,
                # merge concurrent same-bucket requests into one device
                # dispatch (the shape buckets above make collisions
                # common under load)
                coalesce_max=8,
                weights=weights,
                device=device,
                # bf16 on the card; the CPU's bf16 convs are slow, so the
                # plain path computes in float32 (as upscale_image does)
                compute_dtype=torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32,
            )
        )
        self.cache = cache or MemoryImageCache()
        self.use_cache = use_cache
        self.job_timeout = job_timeout

        self._upscaler = None
        self._upscaler_lock = threading.RLock()
        self._pending_lock = threading.RLock()
        # request id -> (event, result slot, the upscaler its job went to)
        self._pending: dict[str, tuple[threading.Event, list, object]] = {}
        self._req_counter = itertools.count()
        self.count = 0
        self.hitcount = 0

        self.app = self._build_router()

    # -- upscaler lifecycle (reference :49-73) ---------------------------

    def _on_result(self, entry, upscaler) -> None:
        if isinstance(entry, EOF):
            # `upscaler`'s worker died (or stopped): wake the requests whose
            # jobs went to it, which then find no result and report its
            # error; jobs already on a replacement worker keep waiting
            with self._pending_lock:
                waiters = [w for w in self._pending.values() if w[2] is upscaler]
            for event, _, _ in waiters:
                event.set()
            return
        with self._pending_lock:
            waiter = self._pending.get(entry.step)
        if waiter is None:
            log.warning("result for unknown request %s", entry.step)
            return
        event, slot, _ = waiter
        slot.append(entry)
        event.set()

    def get_pipeline(self):
        with self._upscaler_lock:
            if self._upscaler is None:
                # each worker's results and EOF name the worker they came from
                owner: list = []
                self._upscaler = self.upscaler_factory(lambda entry: self._on_result(entry, owner[0]))
                owner.append(self._upscaler)
                self._upscaler.start()
                log.info("upscaler started")
            return self._upscaler

    def restart_pipeline(self) -> None:
        with self._upscaler_lock:
            # a worker that failed is replaced at once, even while its
            # thread is still on its way out
            if self._upscaler is not None and (self._upscaler._dead or not self._upscaler.is_alive):
                self._upscaler = None
            self.get_pipeline()

    # -- image plumbing ----------------------------------------------------

    @staticmethod
    def _decode(buffer: bytes):
        """PIL decode + mode normalization (reference :200-246). Returns
        (rgb ndarray, alpha ndarray | None, is_mono) or (None, None, False)."""
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        try:
            pil_img = Image.open(io.BytesIO(buffer))
            # detect mono BEFORE converting (reference :200-246) — after
            # convert('RGB') the array is always 3-D and the flag dead
            is_mono = pil_img.mode in ("1", "L", "I", "F", "I;16")
            if pil_img.mode not in ("RGB", "RGBA"):
                if pil_img.mode in ("LA",) or (
                    pil_img.mode == "P" and "transparency" in pil_img.info
                ):
                    pil_img = pil_img.convert("RGBA")
                else:
                    pil_img = pil_img.convert("RGB")
            img = np.asarray(pil_img)
        except Exception:
            return None, None, False
        if img.ndim == 2:
            is_mono = True
            img = np.repeat(img[:, :, None], 3, axis=-1)
        alpha = None
        if img.shape[-1] == 4:
            alpha = img[:, :, -1]
            img = img[:, :, :3]
        return img, alpha, is_mono

    @staticmethod
    def _scales(h: int, w: int) -> tuple[float, float]:
        """Pre/post scale heuristics by pixel count (reference :148-150,
        :258-263)."""
        pre_scale, post_scale = 1.0, 0.66
        if h * w > 1024 * 1024:
            pre_scale, post_scale = 0.8, 0.85
        if h * w < 64 * 32:
            post_scale = 1.0
        return pre_scale, post_scale

    def process_image(self, buffer: bytes, profiler: Profiler) -> tuple[bytes | None, str, str]:
        """Returns (encoded bytes | None, filename, error message)."""
        import cv2

        # request key must be unique even for identical content: keying by
        # content sha1 alone lets concurrent duplicate uploads overwrite
        # each other's pending-result waiters
        my_id = f"{get_bytes_hash(buffer)}-{next(self._req_counter)}"
        filename = my_id.split("-")[0] + ".png"

        profiler.start("endpoint.io.imdecode")
        img, alpha, is_mono = self._decode(buffer)
        profiler.end("endpoint.io.imdecode")
        if img is None:
            return None, filename, "img is none. did you give correct image blob?"
        if img.ndim != 3 or img.shape[-1] != 3:
            return None, filename, f"img must be RGB or RGBA but got {img.shape}"
        h, w = img.shape[:2]
        if h * w > MAX_PIXELS:
            return None, filename, f"img is too big! {img.shape} > (4096x2048)"

        pre_scale, post_scale = self._scales(h, w)
        if pre_scale < 1.0:
            img = cv2.resize(
                img, None, fx=pre_scale, fy=pre_scale, interpolation=cv2.INTER_AREA
            )

        # shape bucketing: edge-pad up to the next SHAPE_BUCKET multiple,
        # and crop the 4x output back after
        bh, bw = img.shape[:2]
        ph = -bh % SHAPE_BUCKET
        pw = -bw % SHAPE_BUCKET
        if (bh + ph) * (bw + pw) > MAX_PIXELS:
            # padding would push the device tensor past the tested
            # maximum: CROP down to the bucket grid instead (<=63 px off
            # the bottom/right edge at the cap boundary; cropping keeps
            # geometry — a non-uniform resize would bake aspect
            # distortion into the upscale)
            bh2 = max(SHAPE_BUCKET, bh // SHAPE_BUCKET * SHAPE_BUCKET)
            bw2 = max(SHAPE_BUCKET, bw // SHAPE_BUCKET * SHAPE_BUCKET)
            img = img[:bh2, :bw2]
            bh, bw = bh2, bw2
            ph = pw = 0
        if ph or pw:
            img = cv2.copyMakeBorder(img, 0, ph, 0, pw, cv2.BORDER_REPLICATE)

        event = threading.Event()
        slot: list = []
        try:
            upscaler = self.get_pipeline()
            with self._pending_lock:
                self._pending[my_id] = (event, slot, upscaler)
            profiler.start("endpoint.proc")
            try:
                upscaler.push_job(
                    UpscalerQueueEntry(
                        frames=img[None],
                        step=my_id,
                        last_modified=time.time(),
                        profiler=profiler,
                    ),
                    timeout=self.job_timeout,
                )
            except (queue.Full, TimeoutError):
                return None, filename, "worker is busy"
            except ServiceDeadException as ex:
                self.restart_pipeline()
                return None, filename, f"worker is dead: {ex}"

            if not event.wait(timeout=self.job_timeout * 5):
                return None, filename, "worker is busy (wait timeout)"
            if not slot:  # woken by the worker's death
                err = upscaler._error
                self.restart_pipeline()
                return None, filename, f"worker is dead: {err!r}"
            entry = slot[0]
            profiler.end("endpoint.proc")
        finally:
            with self._pending_lock:
                self._pending.pop(my_id, None)

        profiler.start("endpoint.write")
        # a view of the service's pinned host buffer
        frame = entry.frames[0]
        if ph or pw:
            scale = frame.shape[0] // img.shape[0]
            frame = frame[: bh * scale, : bw * scale]
        frame = np.ascontiguousarray(frame)
        if post_scale < 1.0:
            frame = cv2.resize(
                frame, None, fx=post_scale, fy=post_scale,
                interpolation=cv2.INTER_AREA,
            )
        if alpha is not None:
            alpha = cv2.resize(
                alpha, (frame.shape[1], frame.shape[0]),
                interpolation=cv2.INTER_LINEAR,
            )
            frame = np.concatenate([frame, alpha[:, :, None]], axis=-1)

        from PIL import Image

        out = io.BytesIO()
        if frame.shape[-1] == 4:
            Image.fromarray(frame).save(out, format="PNG", optimize=False)
        else:
            Image.fromarray(frame).save(
                out, format="JPEG", progressive=True, quality=85, optimize=True
            )
        profiler.end("endpoint.write")
        return out.getvalue(), filename, ""

    # -- routes ---------------------------------------------------------------

    def _build_router(self) -> Router:
        router = Router()
        backend = self

        @router.route("/upscale/ping")
        def ping(req, start_response):
            return bytes_response(start_response, b"pong", "text/plain")

        @router.route("/upscale/file/<filename>")
        def get_file(req, start_response, filename):
            if any(tok in filename for tok in FORBIDDEN):
                return json_response(
                    start_response,
                    {"status": "err", "err": f"forbidden path {filename}"},
                    "500 Internal Server Error",
                )
            buf = backend.cache.read_file(filename)
            if buf is None:
                return json_response(
                    start_response,
                    {"status": "err", "err": "file not found"},
                    "404 Not Found",
                )
            data = buf.getvalue()
            return bytes_response(start_response, data, image_content_type(data))

        @router.route("/upscale/image", "POST")
        def upscale_image(req, start_response):
            backend.count += 1
            profiler = Profiler()
            profiler.start("endpoint")
            return_type = req.query.get("return_type", "file")
            if return_type not in ("url", "file"):
                return json_response(
                    start_response,
                    {"result": "err", "err": f"unknown return type {return_type}"},
                    "500 Internal Server Error",
                )
            if return_type == "url" and not backend.use_cache:
                # without a cache there is no /upscale/file/<name> to
                # point at — returning raw bytes to a client expecting
                # {'url': ...} would silently break the contract
                return json_response(
                    start_response,
                    {"result": "err",
                     "err": "return_type=url requires --use-cache"},
                    "400 Bad Request",
                )
            profiler.start("endpoint.io.read")
            buffer = req.file("file")
            profiler.end("endpoint.io.read")
            if not buffer:
                return json_response(
                    start_response,
                    {"result": "err", "err": "no file uploaded"},
                    "500 Internal Server Error",
                )

            filename = get_bytes_hash(buffer) + ".png"
            if backend.use_cache:
                cached = backend.cache.has_file(filename)
                if cached is not None:
                    backend.hitcount += 1
                    if return_type == "url":
                        return json_response(
                            start_response,
                            {"result": "ok", "cache": "hit", "url": cached,
                             "profiler": profiler.data},
                        )
                    buf = backend.cache.read_file(filename)
                    if buf is not None:
                        return bytes_response(
                            start_response,
                            buf.getvalue(),
                            image_content_type(buf.getvalue()),
                        )

            data, filename, err = backend.process_image(buffer, profiler)
            if data is None:
                return json_response(
                    start_response,
                    {"result": "err", "err": err, "profiler": profiler.data},
                    "500 Internal Server Error",
                )
            profiler.end("endpoint")

            if backend.use_cache:
                url = backend.cache.write_file(filename, io.BytesIO(data))
                if return_type == "url":
                    return json_response(
                        start_response,
                        {"result": "ok", "cache": "miss", "url": url,
                         "profiler": profiler.data},
                    )
            return bytes_response(start_response, data, image_content_type(data))

        @router.route("/upscale/stats")
        def stats(req, start_response):
            return json_response(
                start_response,
                {
                    "count": backend.count,
                    "hitcount": backend.hitcount,
                    "worker_alive": bool(
                        backend._upscaler and backend._upscaler.is_alive
                    ),
                },
            )

        return router


def create_app(**kwargs):
    return ImageBackend(**kwargs).app


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.image_server.backend")
    p.add_argument("--port", type=int, default=8087)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--use-cache", action="store_true")
    p.add_argument("--weights", default=None,
                   help="SRVGG general-x4v3 .pth in the reference layout (default: seeded weights)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cpu: the plain PyTorch path)")
    args = p.parse_args(argv)
    from ..utils import resolve_device
    from .http_util import serve

    # resolve the device from the MAIN thread before the worker thread
    # exists (a CUDA device without CUDA raises here, at startup), and
    # build K4 before serving: nvcc at the first launch would run inside
    # the first request's push and wait timeouts
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _build

        torch.cuda.init()
        t0 = time.perf_counter()
        _build.build(["conv_stack"])
        log.info("K4 (conv_stack) built in %.1f s on %s", time.perf_counter() - t0,
                 torch.cuda.get_device_name(dev))

    backend = ImageBackend(use_cache=args.use_cache, device=args.device, weights=args.weights)
    # start the upscaler now: its worker loads the weights while the
    # server comes up, not inside the first request
    backend.get_pipeline()
    log.info("image backend on %s:%d (%s)", args.host, args.port, dev)
    serve(backend.app, args.port, args.host)


if __name__ == "__main__":
    main()
