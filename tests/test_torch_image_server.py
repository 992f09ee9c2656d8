"""The port's image service (sharkshark_tpu_torch.image_server) on the CPU
in float32, with a tiny SRVGG (num_feat=16, num_conv=2): the cases of
tests/test_image_server.py run against the port's modules; the port's
backend against the JAX backend on one shared .pth, the same request
bytes posted to both over HTTP; the frontend's stdlib proxy; the load
test; and the service's failure paths.

Tolerances: PNG outputs may differ by 1 on uint8 (the model's outputs
already may: a float32 value that differs in its last bits falls on the
other side of the truncating cast); JPEG outputs, decoded, at >= 40 dB
(the encoder can turn a 1-LSB difference into a few)."""

import concurrent.futures
import io
import itertools
import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import cv2
import httpx
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sharkshark_tpu.image_server import ImageBackend as JBackend
from sharkshark_tpu.image_server import serve_background as jserve_background
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu.utils import env as jenv
from sharkshark_tpu_torch.image_server import (
    CacheFrontend,
    DiskImageCache,
    ImageBackend,
    LocalLockRegistry,
    MemoryImageCache,
    ReaderWriterObject,
    serve_background,
)
from sharkshark_tpu_torch.image_server import backend as backend_mod
from sharkshark_tpu_torch.image_server.http_util import Request, multipart_body, post_file
from sharkshark_tpu_torch.models import srvgg
from sharkshark_tpu_torch.tools import load_test
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService
from sharkshark_tpu_torch.utils import env

TINY = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A tiny SRVGG checkpoint in the reference key layout, which both
    backends' services load through their own from_torch."""
    tp = srvgg.init_params(torch.Generator().manual_seed(14), TINY)
    rng = np.random.default_rng(14)
    sd = {}
    for i, (conv, act) in enumerate(zip(tp["convs"], tp["acts"])):
        sd[f"body.{2 * i}.weight"] = conv["w"].permute(3, 2, 0, 1).contiguous()
        sd[f"body.{2 * i}.bias"] = torch.from_numpy((rng.standard_normal(16) * 0.01).astype(np.float32))
        sd[f"body.{2 * i + 1}.weight"] = act["alpha"]
    n = len(tp["convs"])
    sd[f"body.{2 * n}.weight"] = tp["tail"]["w"].permute(3, 2, 0, 1).contiguous()
    sd[f"body.{2 * n}.bias"] = tp["tail"]["b"]
    path = tmp_path_factory.mktemp("w") / "srvgg-tiny.pth"
    torch.save({"params": sd}, path)
    return str(path)


def _service_kw(weights):
    """The backend's service settings (SR only, one frame a request, 4x
    out, coalescing) at the tiny config in float32."""
    return dict(lr_level=0, denoising=False, batch_size=1, lr_hr_resize=False, output_shape=None,
                coalesce_max=8, weights=weights)


def _tiny_factory(weights):
    def factory(on_queue):
        return EsrganUpscalerService(on_queue=on_queue, compute_dtype=torch.float32, srvgg_cfg=TINY,
                                     device="cpu", **_service_kw(weights))

    return factory


def _png_bytes(h=24, w=32, mode="RGB", value=128):
    arr = np.full((h, w, 3), value, np.uint8)
    img = Image.fromarray(arr).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _serve(app):
    httpd = serve_background(app, port=0)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def backend_server(weights):
    backend = ImageBackend(upscaler_factory=_tiny_factory(weights), use_cache=True)
    httpd, url = _serve(backend.app)
    yield url, backend
    httpd.shutdown()
    httpd.server_close()


# ---------------------------------------------------- tests/test_image_server.py


def test_ping(backend_server):
    url, _ = backend_server
    r = httpx.get(f"{url}/upscale/ping", timeout=10)
    assert r.status_code == 200 and r.text == "pong"


def test_upscale_image_roundtrip(backend_server):
    url, _ = backend_server
    r = httpx.post(f"{url}/upscale/image", files={"file": _png_bytes()},
                   params={"return_type": "file"}, timeout=120)
    assert r.status_code == 200, r.text
    out = Image.open(io.BytesIO(r.content))
    # 24x32 is under the 64*32 pixel floor -> post_scale 1.0, so pure x4
    assert out.size == (32 * 4, 24 * 4)


def test_upscale_url_mode_and_cache_hit(backend_server):
    url, _ = backend_server
    png = _png_bytes(value=77)
    r1 = httpx.post(f"{url}/upscale/image", files={"file": png}, params={"return_type": "url"}, timeout=120)
    assert r1.status_code == 200
    body = r1.json()
    assert body["result"] == "ok" and body["url"].startswith("/upscale/file/")
    r2 = httpx.post(f"{url}/upscale/image", files={"file": png}, params={"return_type": "url"}, timeout=120)
    assert r2.json()["cache"] == "hit"
    r3 = httpx.get(f"{url}{body['url']}", timeout=10)
    assert r3.status_code == 200 and len(r3.content) > 0


def test_alpha_image_returns_png_with_alpha(backend_server):
    url, _ = backend_server
    arr = np.full((20, 20, 4), 100, np.uint8)
    arr[..., 3] = 200
    buf = io.BytesIO()
    Image.fromarray(arr, "RGBA").save(buf, format="PNG")
    r = httpx.post(f"{url}/upscale/image", files={"file": buf.getvalue()}, timeout=120)
    assert r.status_code == 200
    assert Image.open(io.BytesIO(r.content)).mode == "RGBA"


def test_bad_blob_is_500(backend_server):
    url, _ = backend_server
    r = httpx.post(f"{url}/upscale/image", files={"file": b"not an image"}, timeout=30)
    assert r.status_code == 500
    assert "img is none" in r.json()["err"]


def test_forbidden_path(backend_server):
    url, _ = backend_server
    r = httpx.get(f"{url}/upscale/file/..%2Fetc", timeout=10)
    assert r.status_code in (404, 500)


def test_frontend_proxies_and_caches(backend_server):
    backend_url, _ = backend_server
    fe = CacheFrontend(backend_url=f"{backend_url}/upscale/image")
    httpd, fe_url = _serve(fe.app)
    try:
        png = _png_bytes(value=55)
        r1 = httpx.post(f"{fe_url}/upscale/image", files={"file": png}, timeout=120)
        assert r1.status_code == 200 and r1.json()["cache"] == "miss"
        r2 = httpx.post(f"{fe_url}/upscale/image", files={"file": png}, timeout=30)
        assert r2.json()["cache"] == "hit"
        r3 = httpx.get(f"{fe_url}{r2.json()['url']}", timeout=10)
        assert r3.status_code == 200
        assert r3.headers["access-control-allow-origin"] == "*"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_memory_cache_lru_eviction():
    c = MemoryImageCache(max_size=100)
    c.write_file("a", io.BytesIO(b"x" * 60))
    time.sleep(0.01)
    c.write_file("b", io.BytesIO(b"y" * 60))
    assert c.has_file("a") is None  # evicted
    assert c.has_file("b") is not None


def test_disk_cache(tmp_path):
    c = DiskImageCache(root=str(tmp_path), max_size=1000)
    url = c.write_file("f.png", io.BytesIO(b"data"))
    assert url == "/upscale/file/f.png"
    assert c.has_file("f.png") is not None
    assert c.read_file("f.png").getvalue() == b"data"
    # second instance claims a different storage dir
    c2 = DiskImageCache(root=str(tmp_path), max_size=1000)
    assert c2.idx != c.idx


def test_rw_lock_allows_concurrent_readers():
    obj = ReaderWriterObject({"k": 1})
    n_inside = []
    barrier = threading.Barrier(3, timeout=5)

    def reader():
        with obj.read() as v:
            barrier.wait()  # all 3 readers inside simultaneously
            n_inside.append(v["k"])

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert n_inside == [1, 1, 1]


def test_local_lock_registry_serializes():
    reg = LocalLockRegistry()
    order = []

    def work(tag):
        lock = reg.file_lock("k")
        lock.acquire()
        order.append(f"{tag}-in")
        time.sleep(0.05)
        order.append(f"{tag}-out")
        lock.release()

    t1 = threading.Thread(target=work, args=("a",))
    t2 = threading.Thread(target=work, args=("b",))
    t1.start(); t2.start(); t1.join(timeout=10); t2.join(timeout=10)
    assert not t1.is_alive() and not t2.is_alive()
    # no interleaving: every -in is followed by its own -out
    assert order[0][:1] == order[1][:1] and order[2][:1] == order[3][:1]


def test_concurrent_duplicate_uploads_both_succeed(backend_server):
    """Identical bytes posted concurrently must not clobber each other's
    pending-result waiters."""
    url, _ = backend_server
    png = _png_bytes(value=201)

    def post():
        return httpx.post(f"{url}/upscale/image", files={"file": png},
                          params={"return_type": "file"}, timeout=120).status_code

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        codes = list(pool.map(lambda _: post(), range(4)))
    assert codes == [200, 200, 200, 200], codes


class FakeRedis:
    """redis-py get/set/exists/lock surface over one shared dict — the
    coordination substrate two frontend hosts would share."""

    def __init__(self):
        self._kv = {}
        self._reg = LocalLockRegistry()

    def get(self, k):
        return self._kv.get(k)

    def set(self, k, v):
        self._kv[k] = v

    def exists(self, k):
        return int(k in self._kv)

    def lock(self, name, timeout=None, blocking_timeout=None):
        return self._reg.file_lock(name, timeout or 30, blocking_timeout or 10)


def test_multihost_frontends_share_redis_cache(backend_server):
    """Two frontends with one shared Redis: A's miss fills the cache; B
    serves the same image as a hit without touching the backend."""
    from sharkshark_tpu_torch.image_server.caches import RedisImageCache

    backend_url, _ = backend_server
    shared = FakeRedis()
    fe_a = CacheFrontend(backend_url=f"{backend_url}/upscale/image", cache=RedisImageCache(client=shared))
    fe_b = CacheFrontend(backend_url="http://127.0.0.1:1/upscale/image",  # unreachable: B must hit
                         cache=RedisImageCache(client=shared))
    ha, url_a = _serve(fe_a.app)
    hb, url_b = _serve(fe_b.app)
    try:
        png = _png_bytes(value=77)
        ra = httpx.post(f"{url_a}/upscale/image", files={"file": png}, timeout=120)
        assert ra.status_code == 200 and ra.json()["cache"] == "miss"
        rb = httpx.post(f"{url_b}/upscale/image", files={"file": png}, timeout=30)
        assert rb.status_code == 200 and rb.json()["cache"] == "hit"
        rfile = httpx.get(f"{url_b}{rb.json()['url']}", timeout=10)
        assert rfile.status_code == 200 and len(rfile.content) > 0
    finally:
        for h in (ha, hb):
            h.shutdown()
            h.server_close()


def _spy_push(backend, seen):
    """Record the frame shapes pushed to the backend's service."""
    svc = backend.get_pipeline()
    orig = svc.push_job

    def spy(entry, *a, **k):
        seen.append(tuple(np.asarray(entry.frames).shape))
        return orig(entry, *a, **k)

    svc.push_job = spy
    return svc, orig


def test_shape_bucketing_bounds_executables(backend_server):
    """Different request sizes inside one SHAPE_BUCKET land on the same
    device shape (so they can share a dispatch) and the output crops back
    to exactly 4x the original size."""
    base, backend = backend_server
    seen = []
    svc, orig = _spy_push(backend, seen)
    try:
        for h, w in [(24, 32), (30, 40), (17, 50)]:
            r = httpx.post(f"{base}/upscale/image", content=_png_bytes(h, w, value=90), timeout=60)
            assert r.status_code == 200
            assert Image.open(io.BytesIO(r.content)).size == (w * 4, h * 4)
    finally:
        svc.push_job = orig
    assert set(seen) == {(1, 64, 64, 3)}, seen


def test_bucket_padding_respects_max_pixels(backend_server, monkeypatch):
    """Near the cap the image is snapped DOWN to the bucket grid instead of
    padded past MAX_PIXELS."""
    base, backend = backend_server
    monkeypatch.setattr(backend_mod, "MAX_PIXELS", 64 * 96)
    seen = []
    svc, orig = _spy_push(backend, seen)
    try:
        # 60x90 passes the raw cap (5400 <= 6144) but buckets to 64x128
        r = httpx.post(f"{base}/upscale/image", content=_png_bytes(60, 90), timeout=60)
        assert r.status_code == 200
    finally:
        svc.push_job = orig
    assert seen and all(s[1] * s[2] <= 64 * 96 for s in seen), seen


def test_url_return_without_cache_is_rejected(weights):
    """return_type=url with use_cache=False must 400, not return bytes."""
    backend = ImageBackend(upscaler_factory=_tiny_factory(weights), use_cache=False)
    httpd, url = _serve(backend.app)
    try:
        r = httpx.post(f"{url}/upscale/image", params={"return_type": "url"},
                       files={"file": ("t.png", _png_bytes())}, timeout=30)
        assert r.status_code == 400, r.status_code
        assert "use-cache" in r.json()["err"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_mono_detection_survives_rgb_convert():
    rgb, alpha, mono = ImageBackend._decode(_png_bytes(mode="L"))
    assert mono and rgb.ndim == 3 and rgb.shape[-1] == 3
    _, _, mono2 = ImageBackend._decode(_png_bytes(mode="RGB"))
    assert not mono2


# ------------------------------------------------------- against the JAX backend


@pytest.fixture(scope="module")
def jax_backend_server(weights):
    def factory(on_queue):
        return JService(on_queue=on_queue, compute_dtype=jnp.float32, srvgg_cfg=TINY_J, **_service_kw(weights))

    backend = JBackend(upscaler_factory=factory, use_cache=False)
    httpd = jserve_background(backend.app, port=0)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _smooth_image(h, w, channels, seed):
    coarse = np.random.default_rng(seed).integers(0, 256, (6, 6, channels), dtype=np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return img.reshape(h, w, channels)


def _encode(arr, fmt, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr, mode).save(buf, format=fmt)
    return buf.getvalue()


PARITY_CASES = {
    # (request bytes, output format): 64x128 at the bucket, post-scaled 0.66
    "rgb": (lambda: _encode(_smooth_image(64, 128, 3, 1), "JPEG"), "JPEG"),
    # alpha: PNG out, alpha resized beside the 4x image
    "rgba": (lambda: _encode(_smooth_image(48, 80, 4, 2), "PNG", "RGBA"), "PNG"),
    "mono": (lambda: _encode(_smooth_image(64, 64, 1, 3), "PNG", "L"), "JPEG"),
    # 50x70 edge-padded to 64x128, the 4x output cropped back
    "padded": (lambda: _encode(_smooth_image(50, 70, 3, 4), "PNG"), "JPEG"),
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_backend_matches_jax_backend(case, backend_server, jax_backend_server):
    make, fmt = PARITY_CASES[case]
    data = make()
    url, _ = backend_server
    got = httpx.post(f"{url}/upscale/image", files={"file": data}, timeout=120)
    want = httpx.post(f"{jax_backend_server}/upscale/image", files={"file": data}, timeout=300)
    assert got.status_code == want.status_code == 200, (got.text[:200], want.text[:200])
    assert got.headers["content-type"] == want.headers["content-type"]
    g, w = (Image.open(io.BytesIO(r.content)) for r in (got, want))
    assert g.format == w.format == fmt and g.mode == w.mode and g.size == w.size
    src = Image.open(io.BytesIO(data))
    post = 1.0 if src.size[0] * src.size[1] < 64 * 32 else 0.66
    assert g.size == tuple(round(s * 4 * post) for s in src.size), (g.size, src.size)
    g, w = np.asarray(g), np.asarray(w)
    if fmt == "PNG":
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1
    else:
        assert _psnr(g, w) >= 40.0


# ------------------------------------------------------------ the stdlib client


@pytest.mark.parametrize("n", [1, 4097, 200_000])
def test_multipart_body_round_trips_through_request(n):
    """Bytes with CRLFs and boundary-like runs come back exact from the
    server's multipart parser."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    data = (data[: n // 2] + b"\r\n--\r\n\r\n" + data[n // 2 :])[:n] if n > 16 else data
    body, ctype = multipart_body(data)
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": "/", "CONTENT_TYPE": ctype,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    assert Request(environ).file("file") == data


def _stub_backend(handler):
    """A one-route WSGI server standing in for the backend."""
    def app(environ, start_response):
        return handler(start_response)

    return _serve(app)


def test_frontend_proxy_maps_backend_failures():
    """The frontend's proxy turns the backend's failures into the JAX
    frontend's JSON errors: unreachable, too slow, or an error reply."""
    png = _png_bytes(value=13)

    def slow(start_response):
        time.sleep(2.0)
        start_response("200 OK", [("Content-Type", "image/png")])
        return [b"late"]

    def failing(start_response):
        start_response("500 Internal Server Error", [("Content-Type", "application/json")])
        return [b'{"result": "err", "err": "worker is dead"}']

    slow_httpd, slow_url = _stub_backend(slow)
    fail_httpd, fail_url = _stub_backend(failing)
    cases = [("http://127.0.0.1:1/upscale/image", "gpu server dead?"),
             (f"{slow_url}/upscale/image", "timeout request upscale/image"),
             (f"{fail_url}/upscale/image", "worker is dead")]
    try:
        for backend_url, err in cases:
            fe = CacheFrontend(backend_url=backend_url, request_timeout=0.5)
            httpd, fe_url = _serve(fe.app)
            try:
                r = httpx.post(f"{fe_url}/upscale/image", files={"file": png}, timeout=30)
            finally:
                httpd.shutdown()
                httpd.server_close()
            assert r.status_code == 500 and err in r.json()["err"], (backend_url, r.text)
            assert fe.cache.has_file(backend_mod.get_bytes_hash(png) + ".png") is None
    finally:
        for h in (slow_httpd, fail_httpd):
            h.shutdown()
            h.server_close()


def test_frontend_hit_serves_the_backends_bytes(backend_server):
    """A miss through the frontend stores exactly what the backend
    returns; the hit serves those bytes back."""
    backend_url, _ = backend_server
    fe = CacheFrontend(backend_url=f"{backend_url}/upscale/image")
    httpd, fe_url = _serve(fe.app)
    try:
        data = _encode(_smooth_image(40, 60, 3, 9), "PNG")
        miss = post_file(f"{fe_url}/upscale/image", data)
        hit = post_file(f"{fe_url}/upscale/image", data)
        direct = post_file(f"{backend_url}/upscale/image", data, params={"return_type": "file"})
        assert miss[0] == hit[0] == direct[0] == 200
        miss, hit = json.loads(miss[1]), json.loads(hit[1])
        assert (miss["cache"], hit["cache"]) == ("miss", "hit") and miss["url"] == hit["url"]
        served = httpx.get(f"{fe_url}{hit['url']}", timeout=10)
        assert served.content == direct[1]
    finally:
        httpd.shutdown()
        httpd.server_close()


# ----------------------------------------------------------------- the load test


def test_load_test_run_against_the_backend(backend_server, monkeypatch):
    url, _ = backend_server
    images = [_encode(_smooth_image(30, 40, 3, 20 + i), "PNG") for i in range(3)]
    # draw the images in turn, so the first round sends each of them
    turn = itertools.cycle(range(len(images)))
    monkeypatch.setattr(load_test.random, "choice", lambda seq: seq[next(turn)])
    res = load_test.run(f"{url}/upscale/image", images, workers=4, rounds=2, requests_per_round=6)
    assert (res["requests"], res["err"], res["ok"]) == (12, 0, 12), res
    # the second round finds every image in the backend's cache
    assert res["rounds"][1]["hit"] == 6 and res["hit"] >= 6
    assert 0 < res["p50_s"] <= res["p99_s"] and res["rps"] > 0


def test_load_test_unique_sends_no_image_twice(weights):
    """With unique, every request of every round is a miss, even behind
    a cache: no image is sent twice in the run."""
    backend = ImageBackend(upscaler_factory=_tiny_factory(weights), use_cache=True)
    httpd, url = _serve(backend.app)
    try:
        images = [_encode(_smooth_image(30, 40, 3, 40 + i), "PNG") for i in range(7)]
        res = load_test.run(f"{url}/upscale/image", images, workers=4, rounds=2, requests_per_round=5,
                            unique=True)
        assert (res["requests"], res["err"], res["hit"]) == (6, 0, 0), res
        assert [r["requests"] for r in res["rounds"]] == [3, 3]
        with pytest.raises(ValueError, match="too few"):
            load_test.run(f"{url}/upscale/image", images[:1], rounds=2, unique=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend._upscaler.stop()


def test_load_test_cli_counts_errors(tmp_path, capsys):
    """The CLI over a folder of images: an unreachable service counts
    every request as an error."""
    for i in range(2):
        (tmp_path / f"{i}.png").write_bytes(_png_bytes(value=i))
    load_test.main(["--url", "http://127.0.0.1:1/upscale/image", "--images", str(tmp_path),
                    "--workers", "2", "--rounds", "2", "--requests-per-round", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("err_rate=1.000" in line for line in lines), lines


# -------------------------------------------------------------- failure paths


def test_dead_worker_fails_waiting_requests_with_its_error(weights):
    """A kernel failure inside the worker fails the request at once, with
    the error's text; the next request gets a fresh worker."""
    calls = []

    class Failing(EsrganUpscalerService):
        def upscale_dispatch(self, frames):
            calls.append(len(frames))
            if len(calls) == 1:
                raise RuntimeError("fused_conv_stack: CUDA kernel launch failed with cudaError_t 1")
            return super().upscale_dispatch(frames)

    def factory(on_queue):
        return Failing(on_queue=on_queue, compute_dtype=torch.float32, srvgg_cfg=TINY, device="cpu",
                       **_service_kw(weights))

    backend = ImageBackend(upscaler_factory=factory, job_timeout=20.0)
    httpd, url = _serve(backend.app)
    try:
        t0 = time.perf_counter()
        r = httpx.post(f"{url}/upscale/image", files={"file": _png_bytes()}, timeout=60)
        assert time.perf_counter() - t0 < 20.0
        assert r.status_code == 500 and "fused_conv_stack" in r.json()["err"], r.text
        r = httpx.post(f"{url}/upscale/image", files={"file": _png_bytes()}, timeout=60)
        assert r.status_code == 200, r.text
        assert httpx.get(f"{url}/upscale/stats", timeout=10).json()["worker_alive"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_late_eof_wakes_only_its_own_workers_requests():
    """A dead worker's EOF that arrives after its replacement took a job
    fails the requests that went to the dead worker, and leaves the job
    on the replacement waiting for its own result."""
    from sharkshark_tpu_torch.runtime import EOF, Profiler
    from sharkshark_tpu_torch.upscale.service import UpscalerQueueEntry

    class FakeUpscaler:
        def __init__(self, on_queue):
            self.on_queue, self.jobs = on_queue, []
            self._dead, self.is_alive, self._error = False, True, None

        def start(self):
            pass

        def push_job(self, entry, timeout):
            self.jobs.append(entry)

    made = []
    backend = ImageBackend(upscaler_factory=lambda on_queue: made.append(FakeUpscaler(on_queue)) or made[-1])
    data = _png_bytes(h=64, w=64)

    def request(out):
        out.append(backend.process_image(data, Profiler()))

    def wait_for(cond):
        t0 = time.perf_counter()
        while not cond():
            assert time.perf_counter() - t0 < 10
            time.sleep(0.005)

    first, second = [], []
    t1 = threading.Thread(target=request, args=(first,))
    t1.start()
    wait_for(lambda: made and made[0].jobs)
    old = made[0]
    old._dead, old._error = True, RuntimeError("kernel launch failed")
    backend.restart_pipeline()
    t2 = threading.Thread(target=request, args=(second,))
    t2.start()
    wait_for(lambda: len(made) == 2 and made[1].jobs)
    old.on_queue(EOF())  # the old worker's EOF, late
    t1.join(timeout=10)
    assert first and first[0][0] is None and "kernel launch failed" in first[0][2], first
    time.sleep(0.05)
    assert not second and t2.is_alive()
    job = made[1].jobs[0]
    made[1].on_queue(UpscalerQueueEntry(frames=np.zeros((1, 256, 256, 3), np.uint8), step=job.step,
                                        last_modified=time.time(), profiler=job.profiler))
    t2.join(timeout=10)
    assert second and second[0][0] is not None and second[0][2] == "", second
    assert backend._upscaler is made[1]


def test_default_service_takes_device_and_weights(weights):
    seen = []
    backend = ImageBackend(device="cpu", weights=weights)
    svc = backend.upscaler_factory(seen.append)
    assert (svc.device.type, svc.weights, svc.coalesce_max) == ("cpu", weights, 8)
    assert svc.compute_dtype == torch.float32  # bf16 on the card
    assert (svc.denoising, svc.batch_size, svc.lr_hr_resize, svc.output_shape) == (False, 1, False, None)
    assert svc.srvgg_cfg == srvgg.GENERAL_X4V3 and svc.conv_stack == srvgg.DEFAULT_CONV_STACK


def test_backend_main_refuses_cuda_without_it(monkeypatch):
    """--device cuda (the default) on a host without CUDA raises at
    startup; it never serves from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend_mod.main(["--port", "0"])


# ------------------------------------------------------------------- utils/env


@pytest.mark.parametrize("n", [0, 1023, 1536, 5 * 1024**2 + 7, 3 * 1024**5])
def test_human_readable_matches_jax(n):
    assert env.human_readable(n) == jenv.human_readable(n)


def test_optional_module_gates(monkeypatch):
    assert env.has_module("numpy") and not env.has_module("no_such_module_xyz")
    assert env.require_module("json").dumps([1]) == "[1]"
    with pytest.raises(ImportError, match="no_such_module_xyz"):
        env.require_module("no_such_module_xyz", "hint")
    monkeypatch.setenv("SHARKSHARK_TWITCH_USERNAME", "bob")
    assert env.stream_credentials() == jenv.stream_credentials()
    assert env.stream_credentials()["username"] == "bob"


def test_backend_and_frontend_clis_on_the_cpu():
    """Both servers as a user starts them (--device cpu; seeded
    general-x4v3 weights): a small upload through the frontend's CLI to
    the backend's, a miss and then a hit."""
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    be, fe = ports
    root = Path(__file__).resolve().parent.parent
    cmds = [["sharkshark_tpu_torch.image_server.backend", "--port", str(be), "--device", "cpu", "--use-cache"],
            ["sharkshark_tpu_torch.image_server.frontend", "--port", str(fe),
             "--backend", f"http://127.0.0.1:{be}/upscale/image"]]
    procs = [subprocess.Popen([sys.executable, "-m", *c, "--host", "127.0.0.1"], cwd=root) for c in cmds]
    try:
        for port in ports:
            deadline = time.monotonic() + 120
            while True:
                try:
                    assert httpx.get(f"http://127.0.0.1:{port}/upscale/ping", timeout=5).text == "pong"
                    break
                except httpx.TransportError:
                    assert all(p.poll() is None for p in procs) and time.monotonic() < deadline
                    time.sleep(0.2)
        data = _png_bytes(16, 16, value=60)
        replies = [post_file(f"http://127.0.0.1:{fe}/upscale/image", data, timeout=120) for _ in range(2)]
        assert [r[0] for r in replies] == [200, 200], replies
        assert [json.loads(r[1])["cache"] for r in replies] == ["miss", "hit"]
        out = httpx.get(f"http://127.0.0.1:{fe}{json.loads(replies[1][1])['url']}", timeout=10)
        assert Image.open(io.BytesIO(out.content)).size == (64, 64)
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)
