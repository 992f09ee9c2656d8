"""BSVD's single-frame path, per-frame stream and whole-clip denoise of
the port (sharkshark_tpu_torch/models/bsvd.py: apply_single,
stream_step, denoise_clip), its chunked path at BSVD-64, the per-frame
denoise step (upscale/steps.py::upscale_single_denoise), the service and
a training step with BSVD-64, against the JAX package's functions on the
CPU in float32, with the same weights (the port's seeded init, handed to
JAX as numpy) and the same numpy inputs.

Tolerances: atol 1e-4 on BSVD's outputs and states (values of order 1,
two U-Nets of float32 sums taken in another order); the port against
itself across paths (chunked vs per-frame) at the same 1e-4; uint8 steps
and services within 1 (a float32 value that differs in its last bits
falls on the other side of the truncating cast); a training step's loss
at rel 1e-5 and each gradient leaf at ||port - jax|| / ||jax|| <= 1e-4,
as tests/test_torch_train.py holds the BSVD-32 recipe (the gradients in
float64, where float32's own floor at BSVD-64 lies above 1e-4: see the
test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.runtime import EOF as JEOF
from sharkshark_tpu.train import denoise as jdenoise
from sharkshark_tpu.train import losses as jlosses
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu.upscale.service import UpscalerQueueEntry as JEntry
from sharkshark_tpu_torch.models import bsvd, srvgg
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.train import denoise, vsr
from sharkshark_tpu_torch.upscale import steps
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService, UpscalerQueueEntry

ATOL = 1e-4
# BSVD-32 and BSVD-64 at their published widths, and the tiny widths the
# steps' tests use
CFGS = {"32": (bsvd.BSVD_32, jbsvd.BSVD_32), "64": (bsvd.BSVD_64, jbsvd.BSVD_64)}
TINY_BSVD, TINY_BSVD_J = bsvd.BSVDConfig(chns=(8, 16, 24)), jbsvd.BSVDConfig(chns=(8, 16, 24))
TINY_SRVGG, TINY_SRVGG_J = srvgg.SRVGGConfig(num_feat=16, num_conv=2), jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
H, W = 16, 24


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach().numpy() if torch.is_tensor(a) else a), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


def _close(got, want, what, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], what=f"{what}.{k}", atol=atol)
        return
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol, err_msg=what)


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _params(cfg, seed=0):
    tp = bsvd.init_params(torch.Generator().manual_seed(seed), cfg)
    return tp, _j(tp)


def _clip(seed, t, h=H, w=W):
    return np.random.default_rng(seed).random((t, 1, h, w, 4), dtype=np.float32)


@pytest.fixture(scope="module", params=sorted(CFGS))
def variant(request):
    cfg, jcfg = CFGS[request.param]
    tp, jp = _params(cfg)
    return cfg, jcfg, tp, jp


def test_bsvd64_is_the_published_config():
    assert bsvd.BSVD_64 == bsvd.BSVDConfig(chns=(64, 128, 256), mid_ch=64, interm_ch=64)
    assert tuple(bsvd.BSVD_64) == tuple(jbsvd.BSVD_64)


def test_apply_single_matches_jax(variant):
    cfg, jcfg, tp, jp = variant
    x = _clip(1, 1)[0]
    got = bsvd.apply_single(tp, torch.from_numpy(x), cfg=cfg)
    assert got.shape == (1, H, W, 3)
    _close(got, jax.jit(jbsvd.apply_single, static_argnames="cfg")(jp, jnp.asarray(x), cfg=jcfg), "apply_single")


def test_stream_step_live_and_flushed_match_jax(variant):
    """A live stream (t_end None) past SHIFT_NUM frames, output and whole
    state each step; then a 3-frame clip flushed with t_end = 3 over
    SHIFT_NUM zero frames."""
    cfg, jcfg, tp, jp = variant
    j_step = jax.jit(jbsvd.stream_step, static_argnames=("cfg", "t_end"))
    frames = _clip(2, bsvd.SHIFT_NUM + 2)
    ts, js = bsvd.init_stream_state(1, H, W, cfg), jbsvd.init_stream_state(1, H, W, jcfg)
    for i, x in enumerate(frames):
        ty, ts = bsvd.stream_step(tp, ts, torch.from_numpy(x), cfg=cfg)
        jy, js = j_step(jp, js, jnp.asarray(x), cfg=jcfg)
        _close(ty, jy, f"live y@{i}")
    _close(bsvd.state_to_numpy(ts), _np(js), "live state")
    assert ts["t"] == int(js["t"]) == bsvd.SHIFT_NUM + 2

    clip = _clip(3, 3)
    ts, js = bsvd.init_stream_state(1, H, W, cfg), jbsvd.init_stream_state(1, H, W, jcfg)
    for i in range(3 + bsvd.SHIFT_NUM):
        x = clip[i] if i < 3 else np.zeros_like(clip[0])
        ty, ts = bsvd.stream_step(tp, ts, torch.from_numpy(x), cfg=cfg, t_end=3)
        jy, js = j_step(jp, js, jnp.asarray(x), cfg=jcfg, t_end=3)
        _close(ty, jy, f"flushed y@{i}")
    _close(bsvd.state_to_numpy(ts), _np(js), "flushed state")


def test_denoise_clip_matches_jax(variant):
    cfg, jcfg, tp, jp = variant
    clip = _clip(4, 5)
    got = bsvd.denoise_clip(tp, torch.from_numpy(clip), cfg=cfg)
    assert got.shape == (5, 1, H, W, 3)
    _close(got, jax.jit(jbsvd.denoise_clip, static_argnames="cfg")(jp, jnp.asarray(clip), cfg=jcfg),
           "denoise_clip")


@pytest.mark.parametrize("splits", [(1, 12), (7, 6)])
def test_chunk_step_over_any_split_equals_denoise_clip(variant, splits):
    """The port's chunk_step chained over a split of a 5-frame clip and
    its SHIFT_NUM flush frames (t_end = 5) equals the port's
    denoise_clip, as the JAX package's chunked path equals its scan."""
    cfg, _, tp, _ = variant
    clip = torch.from_numpy(_clip(5, 5))
    want = bsvd.denoise_clip(tp, clip, cfg=cfg)
    frames = torch.cat([clip, torch.zeros((bsvd.SHIFT_NUM,) + clip.shape[1:])])
    state, outs, lo = bsvd.init_chunk_state(1, H, W, cfg), [], 0
    for n in splits + (len(frames) - sum(splits),):
        y, state = bsvd.chunk_step(tp, state, frames[lo : lo + n], cfg=cfg, t_end=5)
        outs.append(y)
        lo += n
    _close(torch.cat(outs)[bsvd.SHIFT_NUM :], want.numpy(), f"chunks {splits}")


def test_live_chunk_step_equals_stream_step(variant):
    """A live stream in chunks of 4 (cold, then warm from frame 16 with
    the skip rings) gives the per-frame stream's outputs frame for frame,
    from the first valid one (SHIFT_NUM) on: before it both give
    pre-valid garbage (the chunked path's is zero where the stream's is
    not)."""
    cfg, _, tp, _ = variant
    frames = torch.from_numpy(_clip(6, 24))
    ss, cs = bsvd.init_stream_state(1, H, W, cfg), bsvd.init_chunk_state(1, H, W, cfg)
    want = []
    for x in frames:
        y, ss = bsvd.stream_step(tp, ss, x, cfg=cfg)
        want.append(y)
    got = []
    for i in range(0, 24, 4):
        y, cs = bsvd.chunk_step(tp, cs, frames[i : i + 4], cfg=cfg, warm=i >= bsvd.SHIFT_NUM)
        got.append(y)
    _close(torch.cat(got)[bsvd.SHIFT_NUM :], torch.stack(want)[bsvd.SHIFT_NUM :].numpy(), "live chunks vs stream")


def test_bsvd64_chunk_step_matches_jax():
    """BSVD-64's chunked path against JAX's over cold -> warm (rings) ->
    ring_to_fifo -> flush, outputs each chunk and the whole state."""
    tp, jp = _params(bsvd.BSVD_64, seed=4)
    j_chunk = jax.jit(jbsvd.chunk_step, static_argnames=("cfg", "warm"))
    frames = _clip(7, 24)
    ts, js = bsvd.init_chunk_state(1, H, W, bsvd.BSVD_64), jbsvd.init_chunk_state(1, H, W, jbsvd.BSVD_64)
    for i in range(0, 24, 4):
        warm = i >= bsvd.SHIFT_NUM
        ty, ts = bsvd.chunk_step(tp, ts, torch.from_numpy(frames[i : i + 4]), cfg=bsvd.BSVD_64, warm=warm)
        jy, js = j_chunk(jp, js, jnp.asarray(frames[i : i + 4]), cfg=jbsvd.BSVD_64, warm=warm)
        _close(ty, jy, f"y@{i}")
    ts, js = bsvd.ring_to_fifo_state(ts, bsvd.BSVD_64), jbsvd.ring_to_fifo_state(js, jbsvd.BSVD_64)
    zeros = np.zeros((8, 1, H, W, 4), np.float32)
    for i in range(2):
        ty, ts = bsvd.chunk_step(tp, ts, torch.from_numpy(zeros), cfg=bsvd.BSVD_64, t_end=24)
        jy, js = j_chunk(jp, js, jnp.asarray(zeros), cfg=jbsvd.BSVD_64, t_end=24)
        _close(ty, jy, f"flush y@{i}")
    _close(bsvd.state_to_numpy(ts), _np(js), "state")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_chunk_step_routes_each_width_before_any_launch(monkeypatch, name):
    """On the kernel route a shift conv takes K1's wrapper where K1 is
    built for its width and the shift-and-concatenate conv elsewhere:
    BSVD-32's 16 shift convs (C = 64, 128) all take K1's, BSVD-64's eight
    at C = 128 take K1's and its eight at C = 256 the plain conv; the
    library route takes the plain conv for all 16."""
    cfg = CFGS[name][0]
    calls = []
    plain = tsm.tsm_conv_plain

    def recorder(tag):
        def fn(x, *a, **k):
            calls.append((tag, x.shape[-1]))
            return plain(x, *a, **k)

        return fn

    monkeypatch.setattr(tsm, "tsm_conv", recorder("kernel"))
    monkeypatch.setattr(tsm, "tsm_conv_plain", recorder("library"))
    tp, _ = _params(cfg)
    x = torch.from_numpy(_clip(8, 4, 8, 8))
    bsvd.chunk_step(tp, bsvd.init_chunk_state(1, 8, 8, cfg), x, cfg=cfg)
    kernel = sorted(c for tag, c in calls if tag == "kernel")
    want = [c for c in cfg.chns[1:] for _ in range(8)]
    assert sorted(c for _, c in calls) == sorted(want)
    assert kernel == sorted(c for c in want if c in tsm.KERNEL_CHANNELS)
    calls.clear()
    bsvd.chunk_step(tp, bsvd.init_chunk_state(1, 8, 8, cfg), x, cfg=cfg, shift_conv="library")
    assert [tag for tag, _ in calls] == ["library"] * bsvd.SHIFT_NUM


def test_upscale_single_denoise_matches_jax():
    """The per-frame denoise step threading its state over 18 frames (the
    denoised frames become real from frame 16), at an LR size that is not
    a multiple of 4 (pad + crop)."""
    sr_t = srvgg.init_params(torch.Generator().manual_seed(0), TINY_SRVGG)
    tp = {"sr": sr_t, "denoise": bsvd.init_params(torch.Generator().manual_seed(1), TINY_BSVD)}
    jp = _j(tp)
    kw = dict(lr_shape=(22, 38), output_shape=(44, 76), denoise_rate=0.75)
    jspec = jsteps.UpscaleSpec(compute_dtype=jnp.float32, **kw)
    tspec = steps.UpscaleSpec(compute_dtype=torch.float32, **kw)

    def j_apply(p, x):
        return jsrvgg.apply_down_rational(p, x, 2, 1, cfg=TINY_SRVGG_J)

    def t_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, cfg=TINY_SRVGG)

    j_step = jax.jit(jsteps.upscale_single_denoise, static_argnums=(0, 4, 5))
    js = jsteps.init_denoise_state(1, jspec, TINY_BSVD_J)
    ts = steps.init_denoise_state(1, tspec, TINY_BSVD)
    frames = np.random.default_rng(9).integers(0, 256, (18, 1, 44, 76, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        jo, js = j_step(j_apply, jp, js, jnp.asarray(f), jspec, TINY_BSVD_J)
        to, ts = steps.upscale_single_denoise(t_apply, tp, ts, torch.from_numpy(f), tspec, TINY_BSVD)
        assert to.shape == (1, 44, 76, 3), i
        _u8_close(to, jo)
    assert ts["t"] == int(js["t"]) == 18
    _close(bsvd.state_to_numpy(ts), _np(js), "state")


def _drive(svc, entry_cls, eof_cls, jobs):
    out = []
    svc.on_queue = out.append
    svc.start()
    for i, frames in enumerate(jobs):
        svc.push_job(entry_cls(frames=frames, step=i), timeout=60)
    svc.push_eof()
    assert svc.wait_eof(timeout=300)
    svc.join(timeout=60)
    assert not svc.is_alive and svc._error is None, svc._error
    assert isinstance(out[-1], eof_cls)
    return np.concatenate([np.asarray(e.frames) for e in out[:-1]])


def test_service_with_bsvd64_matches_jax_service(tmp_path):
    """EsrganUpscalerService(bsvd_cfg=BSVD_64) on BSVD-64 weights written
    by bsvd.to_torch (the reference layout both services load), cold and
    warm micro-batches, then the drain: N + min(N, 16) frames."""
    den = bsvd.init_params(torch.Generator().manual_seed(2), bsvd.BSVD_64)
    torch.save(bsvd.to_torch(den), tmp_path / "bsvd64.pth")
    sr = srvgg.init_params(torch.Generator().manual_seed(3), TINY_SRVGG)
    torch.save(srvgg.to_torch(sr), tmp_path / "srvgg.pth")
    kw = dict(lr_level=0, denoising=True, denoise_rate=0.75, batch_size=4, output_shape=(32, 48),
              weights=str(tmp_path / "srvgg.pth"), denoise_weights=str(tmp_path / "bsvd64.pth"))
    jsvc = JService(compute_dtype=jnp.float32, srvgg_cfg=TINY_SRVGG_J, bsvd_cfg=jbsvd.BSVD_64, **kw)
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, srvgg_cfg=TINY_SRVGG, bsvd_cfg=bsvd.BSVD_64,
                                 device="cpu", **kw)
    jsvc.lr_shape = tsvc.lr_shape = (H, W)
    rng = np.random.default_rng(10)
    jobs = [rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8) for _ in range(5)]
    got = _drive(tsvc, UpscalerQueueEntry, EOF, jobs)
    want = _drive(jsvc, JEntry, JEOF, jobs)
    assert got.shape == (20 + 16, 32, 48, 3)
    _u8_close(got, want)


def _unflatten(like, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        return next(it)

    return rebuild(like)


def test_bsvd64_training_step_matches_jax():
    """The denoise recipe (clip_forward over the library route,
    Charbonnier) at BSVD-64 against jax.value_and_grad of the JAX
    recipe's loss, on one noisy clip: the loss in float32 at rel 1e-5,
    and the loss and every gradient leaf with both packages in float64
    (loss rel 1e-5, leaves 1e-4).  At BSVD-64's widths float32's own
    floor lies above 1e-4 in both packages on this clip: the JAX
    package's float32 gradient strays up to 6e-3 from its float64 one,
    the port's up to 2e-4, while the two float64 gradients agree to
    1e-13."""
    tp, _ = _params(bsvd.BSVD_64, seed=5)
    rng = np.random.default_rng(11)
    gt = rng.random((1, 3, H, W, 3), dtype=np.float32)
    sigma = np.float32(25 / 255)
    noisy = gt + sigma * rng.standard_normal(gt.shape).astype(np.float32)
    noisy4 = np.concatenate([noisy, np.full(gt.shape[:-1] + (1,), sigma, np.float32)], -1)
    loss_fn = denoise.make_denoise_loss_fn(denoise.DenoiseTrainConfig(model_cfg=bsvd.BSVD_64))

    def jloss(params, x, y):
        out = jdenoise.clip_forward(params, x.transpose(1, 0, 2, 3, 4), cfg=jbsvd.BSVD_64)
        return jlosses.charbonnier_loss(out.transpose(1, 0, 2, 3, 4), y)

    def port(dtype):
        params = _unflatten(tp, [t.detach().to(dtype).requires_grad_(True) for t in vsr.param_leaves(tp)])
        loss, _ = loss_fn(params, torch.from_numpy(noisy4).to(dtype), torch.from_numpy(gt).to(dtype))
        return float(loss.detach()), torch.autograd.grad(loss, vsr.param_leaves(params))

    loss32, _ = port(torch.float32)
    jl32 = jax.jit(jloss)(_j(tp), jnp.asarray(noisy4), jnp.asarray(gt))
    np.testing.assert_allclose(loss32, float(jl32), rtol=1e-5)
    loss64, grads = port(torch.float64)
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), _np(tp))
        jl, jg = jax.jit(jax.value_and_grad(jloss))(f64, jnp.asarray(noisy4, jnp.float64),
                                                    jnp.asarray(gt, jnp.float64))
        want = jax.tree.leaves(_np(jg))
        jl = float(jl)
    np.testing.assert_allclose(loss64, jl, rtol=1e-5)
    got = jax.tree.leaves(_np(_unflatten(tp, grads)))
    assert len(got) == len(want) == 2 * 2 * (8 + 8)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-12
