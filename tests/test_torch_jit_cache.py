"""The port's upscale/jit_cache.py against the JAX package's, and the
port's single-device services through their ShapeCaches, on the CPU in
float32 at tiny sizes.

On the CPU every call of a ShapeCache runs its function eagerly, so the
services must equal the port's eager step functions, driven as the
services drive them, bit for bit; against the JAX services the uint8
outputs may differ by 1 (a float32 value that differs in its last bits
falls on the other side of an integer step of the truncating cast).
The weights come from the JAX package's seeded init through the port's
from_jax; the frames from a numpy seed.  The CUDA graph path is held on
the card by tests/test_torch_jit_cache_cuda.py."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.upscale import jit_cache as jjit
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu.upscale.service import EgvsrUpscalerService as JEgvsrService
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.ops import _build
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.pipeline import UpscalePipeline
from sharkshark_tpu_torch.stream import BufferedOutputStream, Recoder, Streamer
from sharkshark_tpu_torch.upscale import (
    EgvsrUpscalerService,
    EsrganUpscalerService,
    ShapeCache,
    enable_persistent_cache,
    jit_cache,
    steps,
)
from sharkshark_tpu_torch.upscale import service as service_mod

SR_J, SR_T = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2), srvgg.SRVGGConfig(num_feat=16, num_conv=2)
BSVD_J, BSVD_T = jbsvd.BSVDConfig(chns=(8, 16, 24)), bsvd.BSVDConfig(chns=(8, 16, 24))
EG_J, EG_T = jegvsr.EGVSRConfig(nf=16, nb=1), egvsr.EGVSRConfig(nf=16, nb=1)
LR, OUT = (24, 40), (48, 80)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (got.shape, want.shape)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def params():
    """The JAX package's seeded weights, and the port's from them."""
    jp = {"sr": jsrvgg.init_params(jax.random.PRNGKey(0), SR_J),
          "denoise": jbsvd.init_params(jax.random.PRNGKey(1), BSVD_J)}
    np_p = _np(jp)
    return jp, {"sr": srvgg.from_jax(np_p["sr"]), "denoise": bsvd.from_jax(np_p["denoise"])}


@pytest.fixture(scope="module")
def eg_params():
    jp = jegvsr.init_params(jax.random.PRNGKey(2), EG_J)
    return jp, egvsr.from_jax(_np(jp))


def _t_apply(p, x):
    return srvgg.apply_down_rational(p, x, 2, 1, cfg=SR_T)


def _j_apply(p, x):
    return jsrvgg.apply_down_rational(p, x, 2, 1, cfg=SR_J)


def _services(jp, tp, **kw):
    """The JAX and the port's EsrganUpscalerService at LR x OUT, with the
    same weights."""
    jsvc = JService(lr_level=0, output_shape=OUT, denoise_rate=0.75, compute_dtype=jnp.float32, srvgg_cfg=SR_J,
                    bsvd_cfg=BSVD_J, **kw)
    tsvc = EsrganUpscalerService(lr_level=0, output_shape=OUT, denoise_rate=0.75, compute_dtype=torch.float32,
                                 srvgg_cfg=SR_T, bsvd_cfg=BSVD_T, device="cpu", **kw)
    for svc, p in ((jsvc, jp), (tsvc, tp)):
        svc.lr_shape = LR
        svc.proc_init()
        svc._sr_params = p["sr"]
        if svc.denoising:
            svc._params = p
    return jsvc, tsvc


def _drain(svc):
    return np.concatenate([np.asarray(e.frames) for e in svc.proc_eof()])


# ------------------------------------------------------------ signatures


@pytest.mark.parametrize("calls, want", [
    ([(1, 36, 64), (1, 36, 64), (2, 36, 64)], 2),   # test_upscale_steps.py's calls
    ([(2, 36, 64), (1, 36, 64), (2, 36, 64), (1, 36, 64), (3, 36, 64)], 3),
    ([(1, 36, 64), (1, 36, 60)], 2),
])
def test_num_signatures_matches_jax(params, calls, want):
    """The same calls through the JAX package's ShapeCache and the port's:
    the same number of signatures."""
    jp, tp = params
    jspec = jsteps.UpscaleSpec(lr_shape=(36, 64), output_shape=(72, 128), compute_dtype=jnp.float32)
    tspec = steps.UpscaleSpec(lr_shape=(36, 64), output_shape=(72, 128), compute_dtype=torch.float32)
    jcache = jjit.ShapeCache(lambda p, f: jsteps.upscale_multi(_j_apply, p, f, jspec))
    tcache = ShapeCache(lambda p, f: steps.upscale_multi(_t_apply, p, f, tspec))
    for i, shape in enumerate(calls):
        frames = _frames(i, shape + (3,))
        _u8_close(tcache(tp["sr"], torch.from_numpy(frames)), jcache(jp["sr"], jnp.asarray(frames)))
    assert tcache.num_signatures == jcache.num_signatures == want
    assert tcache.num_graphs == 0  # nothing is captured on the CPU


def test_signature_reads_static_leaves_by_repr():
    """A non-tensor leaf enters the signature by repr, as in the JAX
    cache; tensors by shape, dtype and device."""
    calls = []
    cache = ShapeCache(lambda x, k: calls.append(k) or k)
    x = torch.ones(3)
    for k in (1, 1, 2, 1):
        assert cache(x, k) == k
    cache(torch.ones(3, dtype=torch.float64), 1)
    cache({"a": x, "b": (x, 3)}, 1)
    cache({"a": x, "b": (x, 3)}, 1)
    assert calls == [1, 1, 2, 1, 1, 1, 1] and cache.num_signatures == 4


# ------------------------------------------------------------ the services


@pytest.mark.parametrize("batch, warm_signatures", [(4, 2), (8, 1)])
def test_denoise_service_equals_eager_steps_and_jax(params, batch, warm_signatures):
    """The denoise service over 48 frames (at micro-batch 4: 4 cold and 8
    warm chunks in 2 ring phases) and the drain: bit for bit the port's
    eager steps driven as the service drives them (the warm ones in
    place), within 1 of the JAX service; the warm cache keyed by the ring
    phase.  Then a second stream after reset_stream equals the first."""
    jp, tp = params
    jsvc, tsvc = _services(jp, tp, denoising=True, batch_size=batch)
    frames = _frames(3, (48, *LR, 3))
    chunks = [frames[i : i + batch] for i in range(0, 48, batch)]

    spec = tsvc.spec
    sub = 4 if batch > 4 else None
    state = steps.init_denoise_state(1, spec, BSVD_T)
    want = []
    for c in chunks:
        warm = state["t"] >= bsvd.SHIFT_NUM
        out, state = steps.upscale_batch_denoise(_t_apply, tp, state, torch.from_numpy(c), spec, BSVD_T, warm=warm,
                                                 sr_sub_batch=sub, inplace=True)
        want.append(out.numpy())
    state = bsvd.ring_to_fifo_state(state, BSVD_T)
    tail = frames[-bsvd.SHIFT_NUM :]
    drained = []
    for i in range(0, bsvd.SHIFT_NUM, batch):
        out, state = steps.flush_batch_denoise(_t_apply, tp, state, torch.from_numpy(tail[i : i + batch]), 48, spec,
                                               BSVD_T)
        drained.append(out.numpy())
    want = np.concatenate(want + drained)

    for stream in range(2):
        got = np.concatenate([tsvc.upscale(c) for c in chunks] + [_drain(tsvc)])
        assert got.shape == (48 + 16, *OUT, 3)
        np.testing.assert_array_equal(got, want)
        if stream == 0:
            _u8_close(got, np.concatenate([jsvc.upscale(c) for c in chunks] + [_drain(jsvc)]))
        tsvc.reset_stream()
    cold = bsvd.SHIFT_NUM // batch
    assert tsvc._cold_step.num_signatures == cold  # one a frame index
    assert tsvc._warm_step.num_signatures == warm_signatures
    assert tsvc._flush_step.num_signatures == bsvd.SHIFT_NUM // batch


def test_warm_step_keyed_by_phase_only_where_the_ring_runs(params):
    """A micro-batch that does not divide the 8-frame ring runs its warm
    skips as FIFOs, which read no frame index: one warm signature."""
    jp, tp = params
    _, tsvc = _services(jp, tp, denoising=True, batch_size=3)
    for i in range(12):
        tsvc.upscale(_frames(i, (3, *LR, 3)))
    assert tsvc._warm_step.num_signatures == 1 and tsvc._cold_step.num_signatures == 6


def test_sr_only_service_equals_eager_steps_and_jax(params):
    """The SR-only service through its cache, a tail micro-batch padded:
    bit for bit steps.upscale_multi on the padded batch, within 1 of the
    JAX service; each batch size its own signature."""
    jp, tp = params
    jsvc, tsvc = _services(jp, tp, denoising=False, batch_size=4)
    for i, n in enumerate((4, 4, 3, 4, 3)):
        frames = _frames(10 + i, (n, *LR, 3))
        got = tsvc.upscale(frames)
        padded = np.concatenate([frames, np.repeat(frames[-1:], 4 - n, axis=0)])
        want = steps.upscale_multi(_t_apply, tp["sr"], torch.from_numpy(padded), tsvc.spec).numpy()[:n]
        np.testing.assert_array_equal(got, want)
        _u8_close(got, jsvc.upscale(frames))
    assert tsvc._multi_step.num_signatures == 1
    tsvc.coalesce_max = 8
    tsvc.upscale(_frames(20, (6, *LR, 3)))
    assert tsvc._multi_step.num_signatures == 2


@pytest.mark.parametrize("chunked", [False, True])
def test_egvsr_service_equals_eager_steps_and_jax(eg_params, monkeypatch, chunked):
    """The EGVSR service through its step's (or chunk's) cache with the
    recurrent state donated, two micro-batches of 3 with a scene cut:
    bit for bit the port's eager steps, within 1 of the JAX service
    (its chunk executable switched on to match the chunked route)."""
    jp, tp = eg_params
    monkeypatch.setenv("SHARKSHARK_EGVSR_CHUNK", "1" if chunked else "0")
    lr, out = (8, 64), (32, 256)
    kw = dict(lr_level=0, output_shape=out, cut_threshold=0.12)
    jsvc = JEgvsrService(compute_dtype=jnp.float32, cfg=EG_J, **kw)
    tsvc = EgvsrUpscalerService(compute_dtype=torch.float32, cfg=EG_T, chunked=chunked, device="cpu", **kw)
    for svc, p in ((jsvc, jp), (tsvc, tp)):
        svc.lr_shape = lr
        svc.proc_init()
        svc._params = p
    state = egvsr.init_recurrent_state(1, *lr, EG_T)
    frames = _frames(5, (6, *lr, 3))
    frames[4] = 255 - frames[4]
    for i in (0, 3):
        batch = frames[i : i + 3]
        got = tsvc.upscale(batch)
        x = torch.from_numpy(batch)
        if chunked:
            want, state = steps.egvsr_upscale_chunk(tp, state, x, tsvc.spec, cut_threshold=0.12, cfg=EG_T)
        else:
            outs = []
            for j in range(3):
                o, state = steps.egvsr_upscale_step(tp, state, x[j : j + 1], tsvc.spec, cut_threshold=0.12, cfg=EG_T)
                outs.append(o)
            want = torch.cat(outs)
        np.testing.assert_array_equal(got, want.numpy())
        _u8_close(got, jsvc.upscale(batch))
    cache = tsvc._chunk_step if chunked else tsvc._step
    assert cache.num_signatures == 1


# ------------------------------------------------------------ warm-up and lifetime


def _port_service(tp, **kw):
    """The port's EsrganUpscalerService at LR x OUT on the CPU, with the
    JAX package's weights."""
    svc = EsrganUpscalerService(lr_level=0, output_shape=OUT, denoise_rate=0.75, compute_dtype=torch.float32,
                                srvgg_cfg=SR_T, bsvd_cfg=BSVD_T, device="cpu", **kw)
    svc.lr_shape = LR
    svc.proc_init()
    svc._sr_params = tp["sr"]
    if svc.denoising:
        svc._params = tp
    return svc


def _egvsr_service(tp, **kw):
    svc = EgvsrUpscalerService(lr_level=0, output_shape=(32, 256), compute_dtype=torch.float32, cfg=EG_T,
                               device="cpu", **kw)
    svc.lr_shape = (8, 64)
    svc.proc_init()
    svc._params = tp
    return svc


@pytest.mark.parametrize("denoising, batch, want", [(True, 4, 8), (True, 8, 4), (True, 3, 8), (False, 4, 2)])
def test_warmup_dispatches_reach_every_graph_of_a_stream(params, denoising, batch, want):
    """The cold chunks, then each warm ring phase twice (run, then
    captured); the SR-only step twice."""
    assert _port_service(params[1], denoising=denoising, batch_size=batch).warmup_dispatches() == want


def test_warm_up_leaves_a_fresh_stream_with_every_signature_seen_twice(params, eg_params):
    """warm_up runs two streams of warm-up dispatches on zeros: the cold
    chunks' signatures (one a frame index) and the warm step's (one a
    ring phase) each seen twice, so that they replay from the next stream
    on; it leaves a fresh stream, equal to a service that was not warmed."""
    tp = params[1]
    frames = _frames(6, (24, *LR, 3))
    chunks = [frames[i : i + 4] for i in range(0, 24, 4)]
    warmed, fresh = (_port_service(tp, denoising=True, batch_size=4) for _ in range(2))
    calls = {}
    for name in ("_cold_step", "_warm_step"):
        cache = getattr(warmed, name)
        calls[name] = []
        fn = cache._fn
        cache._fn = lambda *a, fn=fn, seen=calls[name]: seen.append(a[3]) or fn(*a)
    warmed.warm_up()
    assert calls == {"_cold_step": [0, 4, 8, 12] * 2, "_warm_step": [16, 20, 16, 20] * 2}
    assert warmed._frames_seen == 0 and warmed._den_state["temp1"]["skip1"].abs().sum() == 0
    for svc in (warmed, fresh):
        svc.outs = np.concatenate([svc.upscale(c) for c in chunks] + [_drain(svc)])
    np.testing.assert_array_equal(warmed.outs, fresh.outs)
    eg_warmed, eg_fresh = (_egvsr_service(eg_params[1]) for _ in range(2))
    eg_warmed.warm_up()
    assert eg_warmed._step.num_signatures == 1
    x = _frames(7, (4, 8, 64, 3))
    np.testing.assert_array_equal(eg_warmed.upscale(x), eg_fresh.upscale(x))


def _caches(svc) -> list:
    return [v for v in vars(svc).values() if isinstance(v, ShapeCache)]


@pytest.mark.parametrize("started", [False, True])
@pytest.mark.parametrize("kind", ["denoise", "sr", "egvsr"])
def test_a_dropped_service_is_freed_without_the_cycle_collector(params, eg_params, kind, started):
    """A service, never started or run to its end of stream, goes with
    its ShapeCaches and their GraphPool as soon as the last reference to
    it is dropped: no reference cycle keeps its graphs (and their device
    memory) until the cycle collector runs."""
    if kind == "egvsr":
        svc, frames = _egvsr_service(eg_params[1]), _frames(8, (4, 8, 64, 3))
    else:
        svc, frames = _port_service(params[1], denoising=kind == "denoise", batch_size=4), _frames(8, (4, *LR, 3))
    gc.collect()
    gc.disable()
    try:
        if started:
            svc.start()
            svc.push_job(service_mod.UpscalerQueueEntry(frames=frames, step=0))
            svc.push_eof()
            assert svc.wait_eof(timeout=60)
            svc.join()
            assert svc._error is None
        else:
            svc.upscale(frames)
        caches = _caches(svc)
        refs = [weakref.ref(x) for x in [svc, *caches, caches[0]._pool]]
        del svc, caches
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


def test_a_finished_pipeline_is_freed_without_the_cycle_collector(params):
    """The pipeline's stages call it back through weak references, so a
    pipeline run to its end of stream and dropped takes its upscaler's
    graphs with it at once."""
    from test_torch_pipeline import FakeAudioGrabber, FakeImageGrabber, ListSink

    h, w = LR
    sink = ListSink()
    stream = BufferedOutputStream("unused", width=OUT[1], height=OUT[0], fps=1000.0, enable_audio=True, sink=sink,
                                  realtime=False)
    upscaler = _port_service(params[1], denoising=True, batch_size=4)
    pipe = UpscalePipeline(url="fake://", fps=8, frame_skips=False, upscaler=upscaler, report_interval=1e9,
                           recoder=Recoder(url="fake://", batch_sec=1, fps=8, image_grabber=FakeImageGrabber(16, h, w),
                                           audio_grabber=FakeAudioGrabber(), overlay=False),
                           streamer=Streamer(resolution=OUT, fps=8, output_stream=stream, overlay=False))
    gc.collect()
    gc.disable()
    try:
        pipe.start()
        pipe.join(timeout=120)
        assert len(sink.frames) == 16 + bsvd.SHIFT_NUM and upscaler._error is None
        refs = [weakref.ref(x) for x in (pipe, upscaler, upscaler._warm_step)]
        del pipe, upscaler, stream
        assert [r() is None for r in refs] == [True] * 3
    finally:
        gc.enable()


def test_close_drops_the_graph_caches_and_proc_init_builds_them_anew(params):
    """close() stops the worker and drops the steps' caches and the stream
    state whatever still refers to the service; proc_init() then builds
    them anew, and the service runs as before."""
    tp = params[1]
    svc = _port_service(tp, denoising=True, batch_size=4)
    chunks = [_frames(9 + i, (4, *LR, 3)) for i in range(6)]
    before = np.concatenate([svc.upscale(c) for c in chunks] + [_drain(svc)])
    svc.start()
    svc.close()
    assert not _caches(svc) and not hasattr(svc, "_den_state") and not svc.is_alive
    svc.proc_init()
    svc._params, svc._sr_params = tp, tp["sr"]
    assert len(_caches(svc)) == 3
    np.testing.assert_array_equal(np.concatenate([svc.upscale(c) for c in chunks] + [_drain(svc)]), before)


# ------------------------------------------------------------ the pieces


def test_fill_copies_sources_that_alias_the_buffers_aside():
    """Static buffers whose new values are each other's old ones (a swap)
    and a value already in its buffer: every buffer ends with the value
    its source had before any copy."""
    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.arange(4.0) + 20
    want = (b.clone(), a.clone(), c.clone())
    jit_cache._fill([(a, b), (b, a[:]), (c, c)])
    for got, w in zip((a, b, c), want):
        assert torch.equal(got, w)


def test_pool_shares_static_buffers_by_key():
    """A GraphPool keeps one set of static buffers per (argument position,
    donated or not, structure, shapes and dtypes): the caches that share
    it read the same tensors for the same argument; another shape or
    structure gets its own, and a non-tensor leaf or a fixed argument
    none."""
    pool = jit_cache.GraphPool()
    w, state = torch.arange(4.0), {"a": torch.zeros(4), "t": 3}
    (wb,), (sb, tb) = pool.statics((w, state), donated=(1,))
    assert tb is None and wb.shape == w.shape and sb.shape == state["a"].shape and len(pool._statics) == 2
    (wb2,), (sb2, _) = pool.statics((w.clone(), {"a": torch.ones(4), "t": 5}), donated=(1,))
    assert wb2 is wb and sb2 is sb and len(pool._statics) == 2
    (wb3,), (sb3, _) = pool.statics((torch.zeros(5), state), donated=())
    assert wb3 is not wb and sb3 is not sb and len(pool._statics) == 4
    # a fixed argument (the weights) is read where it lies: no buffer
    (wb4,), (sb4, _) = pool.statics((w, state), donated=(1,), fixed=(0,))
    assert wb4 is None and sb4 is sb and len(pool._statics) == 4
    with pytest.raises(ValueError, match="donated or fixed"):
        ShapeCache(abs, donate_argnums=(0,), fixed_argnums=(0,))


def _kind(out):
    return out[0] if isinstance(out, tuple) else "eager"


def test_max_graphs_caps_the_captures(monkeypatch):
    """A cache captures the first MAX_GRAPHS signatures that recur and
    keeps them; any other signature runs eagerly at every call, so what
    its graphs hold stays bounded however many shapes come.  The device's
    warm-up, capture and replay are stood in for on the CPU."""

    class Graph:
        def __init__(self, fn):
            self.fn = fn

        def result(self):
            return ("capture", None)

        def replay(self, leaves):
            return ("replay", self.fn(*leaves))

    monkeypatch.setattr(jit_cache, "_graph_device", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(ShapeCache, "_warm_up", lambda self, dev, args: ("warm", self._fn(*args)))
    monkeypatch.setattr(ShapeCache, "_capture", lambda self, dev, args, struct, leaves: Graph(self._fn))
    monkeypatch.setattr(jit_cache, "MAX_GRAPHS", 3)
    cache = ShapeCache(lambda x: float(x.sum()))
    xs = [torch.ones(k + 1) for k in range(6)]
    with torch.no_grad():  # with grad enabled a call runs eagerly
        rounds = [[cache(x) for x in xs] for _ in range(3)]
    assert [_kind(o) for o in rounds[0]] == ["warm"] * 6
    assert [_kind(o) for o in rounds[1]] == ["capture"] * 3 + ["eager"] * 3
    assert [_kind(o) for o in rounds[2]] == ["replay"] * 3 + ["eager"] * 3
    assert rounds[2][3:] == [4.0, 5.0, 6.0] and [o[1] for o in rounds[2][:3]] == [1.0, 2.0, 3.0]
    assert cache.num_graphs == 3 and cache.num_signatures == 6


def test_counter_delta_is_added_again():
    """A replay adds the launch counts that its capture recorded, the
    per-device dicts key by key."""
    saved = [(m, n, getattr(m, n)) for m, n in jit_cache._COUNTERS]
    try:
        tsm.launches, cs.launches, wp.launches, tsm.pair_launches = 5, 7, 1, 0
        tsm.launches_by_device, cs.launches_by_device = {0: 5}, {}
        before = jit_cache._read_counters()
        tsm.launches, cs.launches, wp.launches = 21, 39, 2
        tsm.launches_by_device[0] = 21
        cs.launches_by_device[0] = 32
        delta = jit_cache._counter_delta(before, jit_cache._read_counters())
        jit_cache._add_counters(delta)
        assert (tsm.launches, cs.launches, wp.launches, tsm.pair_launches) == (37, 71, 3, 0)
        assert tsm.launches_by_device == {0: 37} and cs.launches_by_device == {0: 64}
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def test_enable_persistent_cache_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", _build.BUILD)
    monkeypatch.delenv("SHARKSHARK_COMPILE_CACHE", raising=False)
    default = _build._lib_path("tsm_conv")
    assert jit_cache.default_cache_dir() == str(_build.PKG / "build") == str(default.parent)
    assert enable_persistent_cache() == str(_build.PKG / "build") and _build._lib_path("tsm_conv") == default
    path = tmp_path / "kernels"
    for _ in range(2):  # idempotent
        assert enable_persistent_cache(str(path)) == str(path) and path.is_dir()
    assert _build._lib_path("tsm_conv") == path / default.name
    monkeypatch.setenv("SHARKSHARK_COMPILE_CACHE", str(tmp_path / "env"))
    assert jit_cache.default_cache_dir() == str(tmp_path / "env")
    assert enable_persistent_cache() == str(tmp_path / "env")
    assert _build._lib_path("conv_stack").parent == tmp_path / "env"
