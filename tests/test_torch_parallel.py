"""The port's multi-device serving paths (sharkshark_tpu_torch/parallel)
against the JAX package's, on the CPU: the JAX factories on the
conftest's 8 virtual CPU devices, the port's on a mesh that repeats the
CPU 8 times (its counterpart of virtual devices), on the same numpy
inputs and weights.  Each sharded result is also held against the port's
own single-device step.

Tolerance: uint8 outputs within 1 (the colour match's statistics are
summed band by band, in another order), state leaves in float32 within
1e-4.  The widths are chosen so that the bands' halos are narrower than
the frame, and the halo tests run the production models at their real
widths and depths over 512 LR columns."""

import os
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu import parallel as jpar
from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu.upscale.service import EgvsrUpscalerService as JEgvsrService
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch import pipeline as pipeline_mod
from sharkshark_tpu_torch.main import upscaler as cli
from sharkshark_tpu_torch.models import bsvd, egvsr, fsrcnn, rrdbnet, srvgg
from sharkshark_tpu_torch.ops import global_color_match, local_color_match
from sharkshark_tpu_torch.parallel import _bands
from sharkshark_tpu_torch.parallel import sharded as sharded_mod
from sharkshark_tpu_torch.stream import grabber
from sharkshark_tpu_torch.upscale import levels, steps
from sharkshark_tpu_torch.upscale import service as service_mod
from sharkshark_tpu_torch.upscale.service import EgvsrUpscalerService, EsrganUpscalerService

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TINY_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
BSVD_J = jbsvd.BSVDConfig(chns=(8, 16, 32), mid_ch=8, in_ch=4, out_ch=3, interm_ch=6)
BSVD_T = bsvd.BSVDConfig(chns=(8, 16, 32), mid_ch=8, in_ch=4, out_ch=3, interm_ch=6)
EG_J = jegvsr.EGVSRConfig(nf=16, nb=1)
EG_T = egvsr.EGVSRConfig(nf=16, nb=1)


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (got.shape, want.shape)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _leaves_close(got, want, atol=1e-4):
    g = [np.asarray(x, np.float32) for x in jax.tree.leaves(got)]
    w = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _port_state(state):
    """A port state (whole or sharded) with numpy leaves, the JAX layout."""
    whole = par.gather_state(state)
    if isinstance(whole, dict):
        return bsvd.state_to_numpy(whole)
    return tuple(t.numpy() for t in whole)


def _cpu_mesh(n=8, spatial=2):
    return par.make_mesh(devices=[CPU] * n, spatial=spatial)


def _specs(lr, out, pix_fmt="rgb24"):
    kw = dict(lr_shape=lr, output_shape=out, denoise_rate=0.75, pix_fmt=pix_fmt)
    return (jsteps.UpscaleSpec(compute_dtype=jnp.float32, **kw),
            steps.UpscaleSpec(compute_dtype=torch.float32, **kw))


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The bands' many small ops run on one intra-op thread: beside other
    test processes, a thread pool a process spends its time waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sr_params():
    tp = srvgg.init_params(torch.Generator().manual_seed(0), TINY)
    return _np(tp), tp


@pytest.fixture(scope="module")
def den_params(sr_params):
    tp = {"sr": sr_params[1], "denoise": bsvd.init_params(torch.Generator().manual_seed(1), BSVD_T)}
    return _np(tp), tp


def _j_apply(p, x):
    return jsrvgg.apply(p, x, cfg=TINY_J)


def _t_apply(p, x):
    return srvgg.apply(p, x, cfg=TINY)


# ------------------------------------------------------------------ mesh


def test_mesh_shapes():
    mesh = _cpu_mesh(8, spatial=2)
    assert mesh.shape == {"data": 4, "spatial": 2} == dict(jpar.make_mesh(8, spatial=2).shape)
    assert mesh.axis_names == ("data", "spatial")
    assert par.pad_batch(5, mesh) == 8 == jpar.pad_batch(5, jpar.make_mesh(8, spatial=2))
    assert par.pad_batch(4, mesh) == 4
    assert par.make_mesh(devices=[CPU] * 6, data=3, spatial=2).shape == {"data": 3, "spatial": 2}


@pytest.mark.parametrize("kw", [dict(devices=[CPU] * 7, spatial=2), dict(devices=[CPU] * 8, data=3, spatial=2)])
def test_mesh_refuses_shapes_that_do_not_tile(kw):
    with pytest.raises(ValueError):
        par.make_mesh(**kw)


@pytest.mark.skipif(torch.cuda.device_count() >= 4, reason="the host has 4 CUDA devices")
def test_mesh_without_devices_wants_distinct_cards():
    """make_mesh(n) takes n distinct CUDA devices and raises when the host
    has fewer, naming the way to repeat a device; nothing falls back to
    the CPU."""
    with pytest.raises(ValueError, match="CUDA device"):
        par.make_mesh(4, spatial=2)


def test_placement_descriptors_match_jax():
    mesh, jmesh = _cpu_mesh(), jpar.make_mesh(8, spatial=2)
    assert tuple(par.replicated(mesh).spec) == tuple(jpar.replicated(jmesh).spec)
    assert tuple(par.batch_sharding(mesh).spec) == tuple(jpar.batch_sharding(jmesh).spec)
    assert tuple(par.spatial_sharding(mesh).spec) == tuple(jpar.spatial_sharding(jmesh).spec)
    assert tuple(par.P("data", None)) == tuple(jpar.P("data", None))
    state = bsvd.init_stream_state(1, 8, 16, BSVD_T)
    jstate = jbsvd.init_stream_state(1, 8, 16, BSVD_J)
    from sharkshark_tpu.parallel.sharded import width_sharding as jws

    got = [tuple(par.width_sharding(mesh)(x).spec) for x in jax.tree.leaves(state)]
    want = [tuple(jws(jmesh)(x).spec) for x in jax.tree.leaves(jstate)]
    assert got == want


# --------------------------------------------------------------- bands


def test_bands_tile_the_frame():
    devs = [CPU] * 8
    bands = _bands.split_width(100, devs, 8, 20)
    # 13 units of 8 over 8 devices: 2 each for the first 5, 1 for the rest
    assert [b.c0 for b in bands] == [0, 16, 32, 48, 64, 80, 88, 96] and bands[-1].c1 == 100
    assert all(a.c1 == b.c0 for a, b in zip(bands, bands[1:]))
    assert all(b.c0 % 8 == 0 and (b.c1 % 8 == 0 or b.c1 == 100) for b in bands)
    assert all(b.lo == max(0, b.c0 - 24) and b.hi == min(100, b.c1 + 24) for b in bands)
    # fewer units than devices: some devices get no band
    assert len(_bands.split_width(24, devs, 8, 8)) == 3
    assert _bands.alignment(4, [(Fraction(3, 2), 1), (2, 2)]) == 4
    assert _bands.alignment(1, [(Fraction(3, 2), 1)]) == 2


@pytest.mark.parametrize("kind", ["bsvd", "egvsr"])
def test_state_round_trip_and_halo_refresh(kind):
    """shard_state then gather_state gives the whole state back; a band's
    halo columns, spoiled, are written back exact from the other bands'
    centres by refresh (every leaf, at its own scale)."""
    g = torch.Generator().manual_seed(5)
    if kind == "bsvd":
        state = bsvd.init_stream_state(1, 8, 68, BSVD_T)
        state = _bands.tree_map(lambda x: torch.randn(x.shape, generator=g) if torch.is_tensor(x) else 3, state)
        frame_w, base_w, align = 66, 68, 4
    else:
        state = tuple(torch.randn(x.shape, generator=g) for x in egvsr.init_recurrent_state(1, 8, 64, EG_T))
        frame_w, base_w, align = 64, 64, 8
    bands = _bands.split_width(frame_w, [CPU] * 4, align, 12)
    leaves = _bands._leaves
    sh = par.shard_state(state, bands, frame_w, base_w)
    assert len(sh.parts) == 4 and all(b.hi - b.lo < frame_w for b in bands)
    for a, b in zip(leaves(par.gather_state(sh)), leaves(state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    fresh = par.shard_state(state, bands, frame_w, base_w)
    # spoil every band's halo columns, then refresh them
    for band, part in zip(bands, sh.parts):
        for leaf, w in zip(leaves(part), leaves(sh.widths)):
            if w is None:
                continue
            ax = leaf.ndim - 2
            sl = _bands.band_slice(band, frame_w, base_w, w, centre=True)
            leaf.narrow(ax, 0, sl.start).fill_(-7.0)
            leaf.narrow(ax, sl.stop, leaf.shape[ax] - sl.stop).fill_(-7.0)
    sh.refresh()
    for part, ref in zip(sh.parts, fresh.parts):
        for a, b in zip(leaves(part), leaves(ref)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ------------------------------------------------------- sharded upscale


@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_sharded_upscale_matches_jax(sr_params, pix_fmt):
    """upscale_multi, batch over 'data' (4) and W over 'spatial' (2),
    local colour match active: the JAX factory, the port's factory and
    the port's single-device step."""
    jp, tp = sr_params
    jspec, tspec = _specs((32, 128), (64, 256), pix_fmt)
    frames = _frames(1, (4, 32, 128, 3))
    jmesh = jpar.make_mesh(8, spatial=2)
    with jmesh:
        want = jpar.make_sharded_upscale(_j_apply, jspec, jmesh)(
            jp, jax.device_put(jnp.asarray(frames), jpar.batch_sharding(jmesh)))
    fn = par.make_sharded_upscale(_t_apply, tspec, _cpu_mesh(), halo=par.upscale_radius(TINY, 4))
    got = fn(tp, torch.from_numpy(frames))
    single = steps.upscale_multi(_t_apply, tp, torch.from_numpy(frames), tspec)
    if pix_fmt == "yuv420p":
        assert got.shape == (4, 64 * 3 // 2, 256)
    _u8_close(got, want)
    _u8_close(got, single)


def test_single_frame_spatial_sharding_matches(sr_params):
    """One frame, W over all 8 devices (bands of 16 LR columns)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    jp, tp = sr_params
    jspec, tspec = _specs((32, 128), (64, 256))
    frame = _frames(2, (1, 32, 128, 3))
    jmesh = jpar.make_mesh(8, spatial=8)
    sh = NamedSharding(jmesh, JP(None, None, ("data", "spatial"), None))
    with jmesh:
        want = jax.jit(lambda p, f: jsteps.upscale_multi(_j_apply, p, f, jspec),
                       in_shardings=(NamedSharding(jmesh, JP()), sh), out_shardings=sh)(
            jp, jax.device_put(jnp.asarray(frame), sh))
    mesh = par.make_mesh(devices=[CPU] * 8, spatial=8)
    got = par.make_sharded_upscale(_t_apply, tspec, mesh, halo=par.upscale_radius(TINY, 4))(
        tp, torch.from_numpy(frame))
    _u8_close(got, want)
    _u8_close(got, steps.upscale_multi(_t_apply, tp, torch.from_numpy(frame), tspec))


def test_sharded_upscale_refuses_a_batch_the_data_axis_does_not_split(sr_params):
    _, tp = sr_params
    _, tspec = _specs((32, 128), (64, 256))
    fn = par.make_sharded_upscale(_t_apply, tspec, _cpu_mesh())
    with pytest.raises(ValueError, match="data axis"):
        fn(tp, torch.from_numpy(_frames(3, (3, 32, 128, 3))))


# ------------------------------------------------------- sharded denoise


DEN_LR, DEN_OUT = (8, 256), (16, 512)


@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_sharded_denoise_matches_jax(den_params, pix_fmt):
    """The W-sharded denoise chunk (BSVD + SR + post, W over all 8
    devices: bands of 32 LR columns with halos), twice with the state
    round-tripping sharded, against the JAX factory and the port's
    single-device step; the states leave within 1e-4."""
    jp, tp = den_params
    jspec, tspec = _specs(DEN_LR, DEN_OUT, pix_fmt)
    f1, f2 = _frames(4, (4, *DEN_LR, 3)), _frames(5, (4, *DEN_LR, 3))
    jmesh = jpar.make_mesh(8, spatial=2)
    jfn = jpar.make_sharded_denoise(_j_apply, jspec, jmesh, BSVD_J)
    with jmesh:
        j1, js = jfn(jp, jsteps.init_denoise_state(1, jspec, BSVD_J), jnp.asarray(f1))
        j2, js = jfn(jp, js, jnp.asarray(f2))
    fn = par.make_sharded_denoise(_t_apply, tspec, _cpu_mesh(), BSVD_T, halo=par.denoise_radius(TINY, BSVD_T))
    t1, ts = fn(tp, steps.init_denoise_state(1, tspec, BSVD_T), torch.from_numpy(f1))
    assert isinstance(ts, par.ShardedState) and len(ts.bands) == 8
    assert all(b.hi - b.lo < DEN_LR[1] for b in ts.bands), "the halos cover the whole frame"
    t2, ts = fn(tp, ts, torch.from_numpy(f2))
    _u8_close(t1, j1)
    _u8_close(t2, j2)
    _leaves_close(_port_state(ts), jax.tree.map(np.asarray, js))
    s1, ss = steps.upscale_batch_denoise(_t_apply, tp, steps.init_denoise_state(1, tspec, BSVD_T),
                                         torch.from_numpy(f1), tspec, BSVD_T)
    s2, ss = steps.upscale_batch_denoise(_t_apply, tp, ss, torch.from_numpy(f2), tspec, BSVD_T)
    _u8_close(t1, s1)
    _u8_close(t2, s2)
    _leaves_close(_port_state(ts), bsvd.state_to_numpy(ss))


def test_band_states_are_refreshed_before_each_call(den_params, monkeypatch):
    """Each band's state, as the factory hands it to the band's chunk
    step, equals the whole state's columns [lo, hi) (the single-device
    step's state), halos included: the factory writes the halos again from
    the other bands' centres before each call.  Without that they would be
    exact only as far from the band's edges as its own padding allows."""
    _, tp = den_params
    _, tspec = _specs(DEN_LR, DEN_OUT)
    seen = []
    front = sharded_mod._denoise_front

    def spy(params, part, *args, **kw):
        seen.append(_bands.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, part))
        return front(params, part, *args, **kw)

    monkeypatch.setattr(sharded_mod, "_denoise_front", spy)
    fn = par.make_sharded_denoise(_t_apply, tspec, _cpu_mesh(), BSVD_T, halo=par.denoise_radius(TINY, BSVD_T))
    ts = ss = steps.init_denoise_state(1, tspec, BSVD_T)
    for i in range(3):
        frames = torch.from_numpy(_frames(20 + i, (4, *DEN_LR, 3)))
        seen.clear()
        _, ts = fn(tp, ts, frames)
        w = DEN_LR[1]
        for band, part in zip(ts.bands, seen):
            for got, want in zip(_bands._leaves(part), _bands._leaves(ss)):
                if not torch.is_tensor(got) or got.ndim < 3:
                    assert got == want
                    continue
                ax, full = got.ndim - 2, want.shape[want.ndim - 2]
                lo, hi = (_bands.cols(c, w, w, full) for c in (band.lo, band.hi))
                torch.testing.assert_close(got, want.narrow(ax, lo, hi - lo), atol=1e-4, rtol=0)
        _, ss = steps.upscale_batch_denoise(_t_apply, tp, ss, frames, tspec, BSVD_T)


def test_sharded_denoise_warm_and_flush_match_jax(den_params):
    """The warm factory (in-place skip rings on the bands) from a state
    after 4 cold chunks, warm chunks with sub-batches of the SR tail
    (T=8, sr_sub_batch=4), then the EOF flush's four chunks through
    make_sharded_denoise_flush, against the JAX factories and the port's
    single-device steps."""
    jp, tp = den_params
    jspec, tspec = _specs(DEN_LR, DEN_OUT)
    frames = _frames(6, (32, *DEN_LR, 3))
    tstate = steps.init_denoise_state(1, tspec, BSVD_T)
    for i in range(0, 16, 4):
        _, tstate = steps.upscale_batch_denoise(_t_apply, tp, tstate, torch.from_numpy(frames[i : i + 4]),
                                                tspec, BSVD_T)
    # the JAX package starts from the same state (test_torch_service holds
    # the two packages' cold chunks together)
    jstate = jax.tree.map(jnp.asarray, bsvd.state_to_numpy(tstate))
    jmesh = jpar.make_mesh(8, spatial=2)
    jwarm = jpar.make_sharded_denoise(_j_apply, jspec, jmesh, BSVD_J, warm=True, sr_sub_batch=4)
    jflush = jpar.make_sharded_denoise_flush(_j_apply, jspec, jmesh, BSVD_J)
    halo = par.denoise_radius(TINY, BSVD_T)
    twarm = par.make_sharded_denoise(_t_apply, tspec, _cpu_mesh(), BSVD_T, warm=True, sr_sub_batch=4, halo=halo)
    tflush = par.make_sharded_denoise_flush(_t_apply, tspec, _cpu_mesh(), BSVD_T, halo=halo)
    single = tstate
    with jmesh:
        for i in (16, 24):
            jo, jstate = jwarm(jp, jstate, jnp.asarray(frames[i : i + 8]))
            to, tstate = twarm(tp, tstate, torch.from_numpy(frames[i : i + 8]))
            so, single = steps.upscale_batch_denoise(_t_apply, tp, single, torch.from_numpy(frames[i : i + 8]),
                                                     tspec, BSVD_T, warm=True, sr_sub_batch=4)
            _u8_close(to, jo)
            _u8_close(to, so)
        jstate = jbsvd.ring_to_fifo_state(jstate, BSVD_J)
        tstate = tstate.map(lambda s: bsvd.ring_to_fifo_state(s, BSVD_T))
        single = bsvd.ring_to_fifo_state(single, BSVD_T)
        for i in range(0, 16, 4):
            tail = frames[16 + i : 20 + i]
            jo, jstate = jflush(jp, jstate, jnp.asarray(tail), jnp.asarray(32, jnp.int32))
            to, tstate = tflush(tp, tstate, torch.from_numpy(tail), 32)
            so, single = steps.flush_batch_denoise(_t_apply, tp, single, torch.from_numpy(tail), 32, tspec, BSVD_T)
            _u8_close(to, jo)
            _u8_close(to, so)
    _leaves_close(_port_state(tstate), jax.tree.map(np.asarray, jstate))
    _leaves_close(_port_state(tstate), bsvd.state_to_numpy(single))
    assert par.gather_state(tstate)["t"] == 48


# --------------------------------------------------------- sharded EGVSR


EG_LR, EG_OUT = (8, 256), (32, 1024)


@pytest.fixture(scope="module")
def eg_params():
    tp = egvsr.init_params(torch.Generator().manual_seed(0), EG_T)
    return _np(tp), tp


@pytest.mark.parametrize("pix_fmt,cut", [("rgb24", None), ("yuv420p", None), ("rgb24", 0.12)])
def test_sharded_egvsr_step_matches_jax(eg_params, pix_fmt, cut, monkeypatch):
    """The W-sharded EGVSR step (bands of 32 LR columns over 8 devices,
    the previous HR frame gathered whole, each band's columns warped from
    it through K3's operator with the band's origin: one call a band and
    frame, on a contiguous flow), three frames with the state
    round-tripping sharded; with the scene-cut test, the third frame is a
    cut."""
    calls = []
    fast = sharded_mod.backward_warp_fast

    def spy(x, flow, **kw):
        calls.append((kw.get("col0"), flow.shape[2], x.shape[2], flow.is_contiguous(), kw.get("skip") is not None))
        return fast(x, flow, **kw)

    monkeypatch.setattr(sharded_mod, "backward_warp_fast", spy)
    jp, tp = eg_params
    jspec, tspec = _specs(EG_LR, EG_OUT, pix_fmt)
    frames = _frames(7, (3, *EG_LR, 3))
    if cut is not None:
        frames[2] = 255 - frames[2]
    jmesh = jpar.make_mesh(8, spatial=8)
    jfn = jpar.make_sharded_egvsr_step(jspec, jmesh, EG_J, cut_threshold=cut)
    fn = par.make_sharded_egvsr_step(tspec, par.make_mesh(devices=[CPU] * 8, spatial=8), EG_T, cut_threshold=cut)
    js = jegvsr.init_recurrent_state(1, *EG_LR, EG_J)
    ts = egvsr.init_recurrent_state(1, *EG_LR, EG_T)
    ss = ts
    for i in range(3):
        with jmesh:
            jo, js = jfn(jp, js, jnp.asarray(frames[i : i + 1]))
        to, ts = fn(tp, ts, torch.from_numpy(frames[i : i + 1]))
        so, ss = steps.egvsr_upscale_step(tp, ss, torch.from_numpy(frames[i : i + 1]), tspec,
                                          cut_threshold=cut, cfg=EG_T)
        assert all(b.hi - b.lo < EG_LR[1] for b in ts.bands), "the halos cover the whole frame"
        sc = EG_T.scale
        assert calls == [(sc * b.lo, sc * (b.hi - b.lo), sc * EG_LR[1], True, cut is not None) for b in ts.bands]
        calls.clear()
        _u8_close(to, jo)
        _u8_close(to, so)
    _leaves_close(_port_state(ts), tuple(np.asarray(x) for x in js))
    _leaves_close(_port_state(ts), tuple(t.numpy() for t in ss))


# ------------------------------------------------------------ services


def _drain(svc):
    return [np.asarray(e.frames) for e in svc.proc_eof()]


def _same_weights(svc, params, jax_side: bool):
    """The service's weights replaced by `params` (a JAX service's as jnp
    arrays), so that all services of a test run the same ones."""
    if jax_side:
        params = jax.tree.map(jnp.asarray, params)
    if isinstance(params, dict) and "denoise" in params:
        svc._params = params
        params = params["sr"]
    svc._sr_params = params
    return svc


def test_service_mesh_denoise_matches_jax(den_params):
    """EsrganUpscalerService(mesh=) runs its denoise chunk (cold, then
    warm), and its EOF flush, through the sharded factories: against the
    JAX service on its mesh and the port's single-device service."""
    jp, tp = den_params

    def make(cls, mesh, **kw):
        svc = cls(denoising=True, batch_size=4, output_shape=(2 * DEN_LR[0], 2 * DEN_LR[1]), mesh=mesh, **kw)
        svc.lr_shape = DEN_LR
        svc.proc_init()
        return _same_weights(svc, jp if cls is JService else tp, cls is JService)

    jsvc = make(JService, jpar.make_mesh(8, spatial=2), compute_dtype=jnp.float32, srvgg_cfg=TINY_J,
                bsvd_cfg=BSVD_J)
    tsvc = make(EsrganUpscalerService, _cpu_mesh(), compute_dtype=torch.float32, srvgg_cfg=TINY, bsvd_cfg=BSVD_T,
                device="cpu")
    ref = make(EsrganUpscalerService, None, compute_dtype=torch.float32, srvgg_cfg=TINY, bsvd_cfg=BSVD_T,
               device="cpu")
    frames = _frames(8, (20, *DEN_LR, 3))
    for i in range(0, 20, 4):
        got = tsvc.upscale(frames[i : i + 4])
        assert got.shape == (4, 2 * DEN_LR[0], 2 * DEN_LR[1], 3)
        _u8_close(got, jsvc.upscale(frames[i : i + 4]))
        _u8_close(got, ref.upscale(frames[i : i + 4]))
    assert isinstance(tsvc._den_state, par.ShardedState)
    got, want, single = _drain(tsvc), _drain(jsvc), _drain(ref)
    assert len(got) == len(want) == len(single) == 1 and got[0].shape == (16, 2 * DEN_LR[0], 2 * DEN_LR[1], 3)
    _u8_close(got[0], want[0])
    _u8_close(got[0], single[0])


def test_service_mesh_sr_only_matches_jax(sr_params):
    """The SR-only service on a 2x2 mesh (batch over 'data', W over
    'spatial'), a tail micro-batch padded, and the batch that the data
    axis cannot split refused at construction."""
    jp, tp = sr_params

    def make(cls, mesh, **kw):
        svc = cls(denoising=False, batch_size=4, output_shape=(64, 256), mesh=mesh, **kw)
        svc.lr_shape = (32, 128)
        svc.proc_init()
        return _same_weights(svc, jp if cls is JService else tp, cls is JService)

    jsvc = make(JService, jpar.make_mesh(4, spatial=2), compute_dtype=jnp.float32, srvgg_cfg=TINY_J)
    tsvc = make(EsrganUpscalerService, par.make_mesh(devices=[CPU] * 4, spatial=2), compute_dtype=torch.float32,
                srvgg_cfg=TINY, device="cpu")
    ref = make(EsrganUpscalerService, None, compute_dtype=torch.float32, srvgg_cfg=TINY, device="cpu")
    for n in (4, 3):
        frames = _frames(9 + n, (n, 32, 128, 3))
        got = tsvc.upscale(frames)
        assert got.shape == (n, 64, 256, 3)
        _u8_close(got, jsvc.upscale(frames))
        _u8_close(got, ref.upscale(frames))
    with pytest.raises(ValueError, match="data axis"):
        EsrganUpscalerService(denoising=False, batch_size=3, mesh=par.make_mesh(devices=[CPU] * 4, spatial=2),
                              device="cpu")
    # a mesh names its devices; device= names only their kind
    with pytest.raises(ValueError, match="exclude"):
        EsrganUpscalerService(device="cuda", mesh=_cpu_mesh())


def test_service_mesh_egvsr_matches_jax(eg_params):
    def make(cls, mesh, **kw):
        svc = cls(output_shape=EG_OUT, mesh=mesh, cut_threshold=None, **kw)
        svc.lr_shape = EG_LR
        svc.proc_init()
        return svc

    jp, tp = eg_params
    jsvc = make(JEgvsrService, jpar.make_mesh(8, spatial=8), compute_dtype=jnp.float32, cfg=EG_J)
    tsvc = make(EgvsrUpscalerService, par.make_mesh(devices=[CPU] * 8, spatial=8), compute_dtype=torch.float32,
                cfg=EG_T, chunked=True, device="cpu")
    ref = make(EgvsrUpscalerService, None, compute_dtype=torch.float32, cfg=EG_T, device="cpu")
    assert not tsvc.chunked  # the chunked route is single-device
    # the same seeded weights in all three
    jsvc._params = jax.tree.map(jnp.asarray, jp)
    tsvc._params = ref._params = tp
    frames = _frames(10, (2, *EG_LR, 3))
    got = tsvc.upscale(frames)
    assert got.shape == (2, *EG_OUT, 3)
    _u8_close(got, jsvc.upscale(frames))
    _u8_close(got, ref.upscale(frames))


# ------------------------------------------------------------------ CLI


def test_cli_parse_mesh():
    mesh = cli.parse_mesh("4,2", "cpu")
    assert mesh.shape == {"data": 4, "spatial": 2} and mesh.device_list == [CPU] * 8
    assert cli.parse_mesh("8", "cpu").shape == {"data": 8, "spatial": 1}
    args = cli.build_parser().parse_args(["--url", "x", "--mesh", "2,2"])
    assert args.mesh == "2,2"
    with pytest.raises(ValueError):
        cli.parse_mesh("1,2,3", "cpu")


LR, OUT = (16, 32), (32, 64)


@pytest.mark.parametrize("model,extra_frames", [("egvsr", 0), ("realesrgan", 8)])
def test_cli_mesh_through_fake_ffmpeg(tmp_path, monkeypatch, model, extra_frames):
    """--mesh 2,2 --device cpu through tests/fake_ffmpeg.py: the exact
    byte count, and every byte within 1 of the same run without --mesh;
    --mesh 2,2 without --device cpu raises on a host without 4 cards."""
    fake = tmp_path / "ffmpeg"
    fake.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{ROOT / "tests" / "fake_ffmpeg.py"}" "$@"\n')
    fake.chmod(0o755)
    src = tmp_path / "source.mp4"
    src.write_bytes(b"")
    monkeypatch.setenv("SHARKSHARK_FFMPEG", str(fake))
    monkeypatch.setenv("FAKE_FFMPEG_FRAMES", "8")
    monkeypatch.setattr(service_mod, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setattr(pipeline_mod, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setitem(grabber.QUALITY_RESOLUTION, "tiny", (LR[1], LR[0]))
    base = ["--url", str(src), "--quality", "tiny", "--fps", "4", "--no-frame-skips", "--no-overlay",
            "--model", model]
    outs = {}
    for name, extra in (("mesh", ["--mesh", "2,2", "--device", "cpu"]), ("single", ["--device", "cpu"])):
        out = tmp_path / f"{name}.raw"
        cli.main([*base, "--output-file", str(out), *extra])
        assert os.path.getsize(out) == (8 + extra_frames) * OUT[0] * OUT[1] * 3
        outs[name] = np.fromfile(out, np.uint8)
    _u8_close(outs["mesh"], outs["single"])
    if torch.cuda.device_count() < 4:
        # no CUDA: resolve_device's RuntimeError; too few cards: the parser's error
        with pytest.raises((RuntimeError, SystemExit)):
            cli.main([*base, "--output-file", str(tmp_path / "x.raw"), "--mesh", "2,2"])


# ---------------------------------------------------------------- halos


def _spread(a: torch.Tensor, b: torch.Tensor, col: int, scale) -> float:
    """How far, in LR columns, the columns where a and b differ reach from
    LR column `col` (axis ndim-2 of a tensor `scale` times the LR width)."""
    d = (a.float() - b.float()).abs()
    d = d.movedim(d.ndim - 2, -1).reshape(-1, d.shape[d.ndim - 2]).amax(0)
    hit = torch.nonzero(d > 0).flatten()
    if len(hit) == 0:
        return 0.0
    return float(max(col - hit.min().item() / scale, (hit.max().item() + 1) / scale - col))


def _perturb(tree, col: int, width: int, seed: int):
    """tree with column `col` (at each image-like leaf's scale of the LR
    width) of every leaf of 3 or more dims changed."""
    g = torch.Generator().manual_seed(seed)

    def leaf(x):
        if not torch.is_tensor(x) or x.ndim < 3:
            return x
        ax = x.ndim - 2
        y = x.clone()
        c = y.select(ax, col * x.shape[ax] // width)
        c.add_(torch.rand(c.shape, generator=g) + 0.25)
        return y

    return _bands.tree_map(leaf, tree)


W, COL = 512, 256


def test_denoise_halo_bounds_the_step_radius():
    """BSVD-32 and SRVGG general-x4v3 (the fused 2/1 epilogue) at their
    real widths and depths, 8 x 512 LR, in the warm regime: one column of
    the input frames and of every state leaf changed moves the step's SR
    output (before the global colour match, the one step that reads the
    whole frame) and its new state only within denoise_radius, the halo
    the service gives its bands; and BSVD's within bsvd_radius."""
    h = 8
    spec = steps.UpscaleSpec(lr_shape=(h, W), output_shape=(2 * h, 2 * W), compute_dtype=torch.float32,
                             denoise_rate=0.75)
    params = {"sr": srvgg.init_params(torch.Generator().manual_seed(0)),
              "denoise": bsvd.init_params(torch.Generator().manual_seed(1))}

    def sr_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1)

    rng = np.random.default_rng(0)
    with torch.no_grad():
        state = steps.init_denoise_state(1, spec)
        for _ in range(5):
            f = torch.from_numpy(rng.integers(0, 256, (4, h, W, 3), dtype=np.uint8))
            _, _, state = steps._denoise_front(params, state, f, spec, bsvd.BSVD_32, warm=state["t"] >= 16)
        f0 = torch.from_numpy(rng.integers(0, 256, (4, h, W, 3), dtype=np.uint8))
        f1 = f0.clone()
        f1[:, :, COL] = 255 - f1[:, :, COL]
        runs = []
        for st, f in ((state, f0), (_perturb(state, COL, steps._ceil4(W), 3), f1)):
            den, lr, new = steps._denoise_front(params, st, f, spec, bsvd.BSVD_32, warm=True)
            runs.append((steps._denoise_local(sr_apply, params, den, lr, spec), new))
    out_spread = _spread(runs[0][0], runs[1][0], COL, 2)
    state_spread = max(_spread(a, b, COL, a.shape[a.ndim - 2] / W)
                       for a, b in zip(_bands._leaves(runs[0][1]), _bands._leaves(runs[1][1]))
                       if torch.is_tensor(a) and a.ndim >= 3)
    radius = par.denoise_radius(srvgg.GENERAL_X4V3, bsvd.BSVD_32)
    assert 0 < state_spread <= par.bsvd_radius(bsvd.BSVD_32)
    assert state_spread < out_spread <= radius, (out_spread, radius)


def test_upscale_halo_bounds_the_step_radius():
    """The SR-only step with SRVGG general-x4v3 through the fused 2/1
    epilogue and the local colour match (active: 80 SR rows), 40 x 512
    LR: one changed input column moves the output only within
    upscale_radius."""
    h = 40
    spec = steps.UpscaleSpec(lr_shape=(h, W), output_shape=(2 * h, 2 * W), compute_dtype=torch.float32)
    params = srvgg.init_params(torch.Generator().manual_seed(0))
    stats = tuple(torch.full((1, 1, 1, 3), v) for v in (0.4, 0.2, 0.5, 0.25))
    f0 = torch.from_numpy(_frames(11, (1, h, W, 3)))
    f1 = f0.clone()
    f1[:, :, COL] = 255 - f1[:, :, COL]
    outs = []
    with torch.no_grad():
        for f in (f0, f1):
            hr, lr = steps._multi_local(lambda p, x: srvgg.apply_down_rational(p, x, 2, 1), params, f, spec)
            outs.append(local_color_match(global_color_match(hr, lr, stats), lr))
    spread = _spread(outs[0], outs[1], COL, 2)
    assert 0 < spread <= par.upscale_radius(srvgg.GENERAL_X4V3, 2), spread


def test_egvsr_halo_bounds_the_step_radius():
    """FRNet nf 64 nb 10 (the production EGVSR), 16 x 512 LR, after three
    frames: one column of the frame and of the LR state changed moves the
    HR output and the new state only within egvsr_radius (the HR state
    is gathered whole each step, so it has no radius)."""
    h = 16
    cfg = egvsr.EGVSRConfig(nb=10)
    spec = steps.UpscaleSpec(lr_shape=(h, W), output_shape=(4 * h, 4 * W), compute_dtype=torch.float32)
    params = egvsr.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        state = egvsr.init_recurrent_state(1, h, W, cfg)
        for _ in range(3):
            f = torch.from_numpy(rng.integers(0, 256, (1, h, W, 3), dtype=np.uint8))
            _, state = steps.egvsr_upscale_step(params, state, f, spec, cfg=cfg)
        f0 = torch.from_numpy(rng.integers(0, 256, (1, h, W, 3), dtype=np.uint8))
        f1 = f0.clone()
        f1[:, :, COL] = 255 - f1[:, :, COL]
        lr_prev = _perturb(state[0], COL, W, 4)
        runs = [egvsr.infer_step(params, st, steps._egvsr_lr(f, spec), cfg=cfg)
                for st, f in ((state, f0), ((lr_prev, state[1]), f1))]
    spread = max(_spread(runs[0][0], runs[1][0], COL, 4), _spread(runs[0][1][0], runs[1][1][0], COL, 1))
    assert 0 < spread <= par.egvsr_radius(cfg), spread


@pytest.mark.parametrize("cfg", [srvgg.GENERAL_X4V3, rrdbnet.RRDBConfig(num_block=1),
                                 rrdbnet.RRDBConfig(num_block=1, scale=2), "fsrcnn"],
                         ids=["srvgg", "rrdb_x4", "rrdb_x2", "fsrcnn"])
def test_sr_models_stay_within_their_radius(cfg):
    """Each SR model the service takes: one changed input column moves
    its output only within sr_radius (RRDBNet at one block: the formula
    grows by 15 LR columns a block, at its pixel-unshuffled half width for
    x2)."""
    h, w, col = 8, 128, 64
    g = torch.Generator().manual_seed(0)
    if cfg == "fsrcnn":
        params, fn, scale = fsrcnn.init_params(g), fsrcnn.apply_rgb, 4
    elif isinstance(cfg, rrdbnet.RRDBConfig):
        params, scale = rrdbnet.init_params(g, cfg), cfg.scale
        fn = lambda p, x: rrdbnet.apply(p, x, cfg=cfg)  # noqa: E731
    else:
        params, fn, scale = srvgg.init_params(g, cfg), lambda p, x: srvgg.apply(p, x, cfg=cfg), 4
    x0 = torch.rand((1, h, w, 3), generator=g)
    x1 = x0.clone()
    x1[:, :, col] = 1 - x1[:, :, col]
    with torch.no_grad():
        spread = _spread(fn(params, x0), fn(params, x1), col, scale)
    assert 0 < spread <= par.sr_radius(cfg), spread
    assert col % par.sr_align(cfg) == 0
