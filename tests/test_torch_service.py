"""The port's upscale steps and EsrganUpscalerService against the JAX
package's, on the CPU in float32 at tiny sizes, with the same weights.

Tolerance: uint8 outputs may differ by 1, where a float32 value that
differs in its last bits (sums in another order) falls on the other side
of an integer step of the truncating cast."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.runtime import EOF as JEOF
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu.upscale.service import UpscalerQueueEntry as JEntry
from sharkshark_tpu_torch.models import bsvd, srvgg
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.upscale import steps
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService, UpscalerQueueEntry

TINY_SRVGG_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY_SRVGG = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY_BSVD_J = jbsvd.BSVDConfig(chns=(8, 16, 24))
TINY_BSVD = bsvd.BSVDConfig(chns=(8, 16, 24))
# the mem blocks' shift convs at K1's widths, where chunk_step takes the
# kernel route (and with tsm_pair the pair on warm chunks)
PAIR_BSVD_J = jbsvd.BSVDConfig(chns=(8, *tsm.KERNEL_CHANNELS))
PAIR_BSVD = bsvd.BSVDConfig(chns=(8, *tsm.KERNEL_CHANNELS))


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _assert_u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def params():
    """Random weights from the port's seeded init, handed to the JAX
    package as numpy (its pytree layout is the same)."""
    tp = {
        "sr": srvgg.init_params(torch.Generator().manual_seed(0), TINY_SRVGG),
        "denoise": bsvd.init_params(torch.Generator().manual_seed(1), TINY_BSVD),
    }
    return _np(tp), tp


def _specs(lr_shape, out_shape):
    kw = dict(lr_shape=lr_shape, output_shape=out_shape, denoise_rate=0.75)
    return (jsteps.UpscaleSpec(compute_dtype=jnp.float32, **kw),
            steps.UpscaleSpec(compute_dtype=torch.float32, **kw))


def _sr_applies():
    def j_apply(p, x):
        return jsrvgg.apply_down_rational(p, x, 2, 1, cfg=TINY_SRVGG_J)

    def t_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, cfg=TINY_SRVGG)

    return j_apply, t_apply


def test_denoise_steps_match_jax(params):
    """upscale_batch_denoise over cold and warm chunks, then the EOF
    flush, at an LR size that is not a multiple of 4 (pad + crop)."""
    jp, tp = params
    jspec, tspec = _specs((22, 38), (44, 76))
    j_apply, t_apply = _sr_applies()
    j_step = jax.jit(jsteps.upscale_batch_denoise, static_argnums=(0, 4, 5, 6))
    j_flush = jax.jit(jsteps.flush_batch_denoise, static_argnums=(0, 5, 6))
    js = jsteps.init_denoise_state(1, jspec, TINY_BSVD_J)
    ts = steps.init_denoise_state(1, tspec, TINY_BSVD)
    frames = np.random.default_rng(0).integers(0, 256, (20, 44, 76, 3), dtype=np.uint8)
    for i in range(0, 20, 4):
        warm = i >= bsvd.SHIFT_NUM
        jo, js = j_step(j_apply, jp, js, jnp.asarray(frames[i : i + 4]), jspec, TINY_BSVD_J, warm)
        to, ts = steps.upscale_batch_denoise(t_apply, tp, ts, torch.from_numpy(frames[i : i + 4]),
                                             tspec, TINY_BSVD, warm=warm)
        assert to.shape == (4, 44, 76, 3)
        _assert_u8_close(to, jo)
    js = jbsvd.ring_to_fifo_state(js, TINY_BSVD_J)
    ts = bsvd.ring_to_fifo_state(ts, TINY_BSVD)
    for i in range(0, bsvd.SHIFT_NUM, 4):
        tail = frames[i : i + 4]
        jo, js = j_flush(j_apply, jp, js, jnp.asarray(tail), jnp.asarray(20, jnp.int32),
                         jspec, TINY_BSVD_J)
        to, ts = steps.flush_batch_denoise(t_apply, tp, ts, torch.from_numpy(tail), 20,
                                           tspec, TINY_BSVD)
        _assert_u8_close(to, jo)
    assert ts["t"] == int(js["t"]) == 36


def test_sr_sub_batch_and_multi_match_jax(params):
    """A T=8 micro-batch with the SR tail in sub-batches of 4, and the
    no-denoise step upscale_multi (local color match active at this HR
    size)."""
    jp, tp = params
    jspec, tspec = _specs((36, 64), (72, 128))
    j_apply, t_apply = _sr_applies()
    frames = np.random.default_rng(1).integers(0, 256, (8, 72, 128, 3), dtype=np.uint8)
    jo, _ = jax.jit(jsteps.upscale_batch_denoise, static_argnums=(0, 4, 5, 6, 7))(
        j_apply, jp, jsteps.init_denoise_state(1, jspec, TINY_BSVD_J), jnp.asarray(frames),
        jspec, TINY_BSVD_J, False, 4)
    to, _ = steps.upscale_batch_denoise(
        t_apply, tp, steps.init_denoise_state(1, tspec, TINY_BSVD), torch.from_numpy(frames),
        tspec, TINY_BSVD, sr_sub_batch=4)
    _assert_u8_close(to, jo)
    jo = jax.jit(jsteps.upscale_multi, static_argnums=(0, 3))(
        j_apply, jp["sr"], jnp.asarray(frames[:2]), jspec)
    to = steps.upscale_multi(t_apply, tp["sr"], torch.from_numpy(frames[:2]), tspec)
    _assert_u8_close(to, jo)


def _conv_sd(prefix, i, o, rng):
    return {
        prefix + "weight": (rng.standard_normal((o, i, 3, 3)) * np.sqrt(2.0 / (9 * i))).astype(np.float32),
        prefix + "bias": (rng.standard_normal(o) * 0.01).astype(np.float32),
    }


def _write_tiny_weights(tmp_path, sr_cfg=TINY_SRVGG, bsvd_cfg=TINY_BSVD):
    """Tiny SRVGG (sr_cfg's widths) and BSVD (bsvd_cfg's) checkpoints in the reference
    key layout, so both services load the same weights through their own
    from_torch."""
    rng = np.random.default_rng(2)
    sd = {}
    n, f = sr_cfg.num_conv + 1, sr_cfg.num_feat
    for i in range(n):
        sd.update(_conv_sd(f"body.{2 * i}.", 3 if i == 0 else f, f, rng))
        sd[f"body.{2 * i + 1}.weight"] = np.full(f, 0.25, np.float32)
    sd.update(_conv_sd(f"body.{2 * n}.", f, 48, rng))
    sr_path = tmp_path / "srvgg-tiny.pth"
    torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, sr_path)

    c0, c1, c2 = bsvd_cfg.chns
    sd = {}
    for net, (cin, cout) in enumerate([(4, bsvd_cfg.mid_ch), (bsvd_cfg.mid_ch, 3)]):
        p = f"base_model.nets_list.{net}."
        for name, i, o in [
            ("inc.convblock.0.", cin, bsvd_cfg.interm_ch), ("inc.convblock.3.", bsvd_cfg.interm_ch, c0),
            ("downc0.convblock.0.", c0, c1), ("downc1.convblock.0.", c1, c2),
            ("upc2.convblock.1.", c2, 4 * c1), ("upc1.convblock.1.", c1, 4 * c0),
            ("outc.convblock.0.", c0, c0), ("outc.convblock.3.", c0, cout),
        ]:
            sd.update(_conv_sd(p + name, i, o, rng))
        for mem, c in [("downc0.convblock.3.", c1), ("downc1.convblock.3.", c2),
                       ("upc2.convblock.0.", c2), ("upc1.convblock.0.", c1)]:
            for conv in ("c1", "c2"):
                sd.update(_conv_sd(f"{p}{mem}{conv}.net.", c, c, rng))
    den_path = tmp_path / "bsvd-tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, den_path)
    return str(sr_path), str(den_path)


def _drive(svc, entry_cls, eof_cls, jobs):
    """start -> push_job per micro-batch -> push_eof, collecting through
    on_queue as the live pipeline does."""
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


def test_service_matches_jax_service(tmp_path):
    sr_w, den_w = _write_tiny_weights(tmp_path)
    kw = dict(lr_level=0, denoising=True, denoise_rate=0.75, batch_size=4,
              output_shape=(48, 80), weights=sr_w, denoise_weights=den_w)
    jsvc = JService(compute_dtype=jnp.float32, srvgg_cfg=TINY_SRVGG_J, bsvd_cfg=TINY_BSVD_J, **kw)
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, srvgg_cfg=TINY_SRVGG,
                                 bsvd_cfg=TINY_BSVD, device="cpu", **kw)
    jsvc.lr_shape = tsvc.lr_shape = (24, 40)
    rng = np.random.default_rng(3)
    # 5 full micro-batches (cold, then warm from frame 16) and a tail of 3
    jobs = [rng.integers(0, 256, (n, 24, 40, 3), dtype=np.uint8) for n in (4, 4, 4, 4, 4, 3)]
    got = _drive(tsvc, UpscalerQueueEntry, EOF, jobs)
    want = _drive(jsvc, JEntry, JEOF, jobs)
    # 23 live frames + the 15 real frames among the last 16 fed
    assert got.shape == (23 + 15, 48, 80, 3)
    _assert_u8_close(got, want)


def test_service_routes_match_jax_service(tmp_path, monkeypatch):
    """The whole denoise service with both kernel routes on (K2 on warm
    chunks, K4 over the SRVGG body two layers a launch; their plain
    versions on the CPU) against the JAX service's XLA route.  The mem
    blocks run at K1's widths, and the pair and K4 wrappers must be
    called."""
    calls = {"pair": 0, "conv_stack": 0}

    def counting(name, mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, attr, wrapped)

    counting("pair", tsm, "tsm_conv_pair")
    counting("conv_stack", cs, "fused_conv_stack")
    sr_j, sr_t = jsrvgg.SRVGGConfig(num_feat=64, num_conv=3), srvgg.SRVGGConfig(num_feat=64, num_conv=3)
    sr_w, den_w = _write_tiny_weights(tmp_path, sr_t, PAIR_BSVD)
    kw = dict(lr_level=0, denoising=True, denoise_rate=0.75, batch_size=4,
              output_shape=(48, 80), weights=sr_w, denoise_weights=den_w)
    jsvc = JService(compute_dtype=jnp.float32, srvgg_cfg=sr_j, bsvd_cfg=PAIR_BSVD_J, **kw)
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, srvgg_cfg=sr_t, bsvd_cfg=PAIR_BSVD,
                                 device="cpu", tsm_pair=True, conv_stack=2, **kw)
    jsvc.lr_shape = tsvc.lr_shape = (24, 40)
    rng = np.random.default_rng(4)
    # 4 cold micro-batches, then 2 warm ones, then the drain
    jobs = [rng.integers(0, 256, (4, 24, 40, 3), dtype=np.uint8) for _ in range(6)]
    got = _drive(tsvc, UpscalerQueueEntry, EOF, jobs)
    # the two warm chunks' 8 mem-block pairs each
    assert calls["pair"] == 16 and calls["conv_stack"] > 0, calls
    want = _drive(jsvc, JEntry, JEOF, jobs)
    assert got.shape == (24 + 16, 48, 80, 3)
    _assert_u8_close(got, want)


def test_service_default_device_is_cuda():
    params = inspect.signature(EsrganUpscalerService).parameters
    assert params["device"].default == "cuda"
    assert params["compute_dtype"].default == torch.bfloat16
    with pytest.raises(ValueError, match="unknown"):
        EsrganUpscalerService(upscaler_model="fsrcnn_x3", device="cpu")
