"""The multi-device serving paths on cards: K1 and K4 against their plain
versions on every visible card (their shared-memory opt-in is made once
per device, so the first launch on a second card must work too), and
the width-sharded denoise and EGVSR steps on a mesh of cards against the
single-device steps (EGVSR's bands warp through K3 with a column origin,
one launch a band and frame).

These tests need NVIDIA GPUs and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA; the per-card test skips below two
cards.  On the card machine, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Tolerance: the kernels within 0.05 x max(|ref|max, 1) in bf16 (as their
own card tests); the sharded step's output at >= 40 dB PSNR of the
single-device one in bf16 (the bar for two routes of one step): a band's
convs run at another width, where cuDNN may sum in another order.
"""

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.upscale import steps

pytestmark = pytest.mark.cuda


def _close(got, want, tol=0.05):
    got, want = got.float(), want.float()
    assert (got - want).abs().max().item() <= tol * max(want.abs().max().item(), 1.0)


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_k1_and_k4_launch_on_every_card(cards):
    if len(cards) < 2:
        pytest.skip("needs two or more cards")
    for dev in cards:
        g = torch.Generator(device=dev).manual_seed(dev.index)
        for c in tsm.KERNEL_CHANNELS:
            x = torch.randn((4, 1, 24, 40, c), generator=g, device=dev).to(torch.bfloat16)
            prev = torch.randn((1, 24, 40, c), generator=g, device=dev).to(torch.bfloat16)
            left = torch.randn((1, 24, 40, c // 8), generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn((3, 3, c, c), generator=g, device=dev) * 0.05).to(torch.bfloat16)
            b = (torch.randn((c,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
            before = tsm.launches_by_device.get(dev.index, 0)
            got = tsm.tsm_conv(x, prev, left, w, b, act="relu6")
            torch.cuda.synchronize(dev)
            assert tsm.launches_by_device[dev.index] == before + 1
            _close(got, tsm.tsm_conv_plain(x, prev, left, w, b, act="relu6"))
        x = torch.randn((2, 40, 72, 64), generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((1, 3, 3, 64, 64), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        a = torch.full((1, 64), 0.25, device=dev)
        bias = torch.randn((1, 64), generator=g, device=dev) * 0.1
        before = cs.launches_by_device.get(dev.index, 0)
        got = cs.fused_conv_stack(x, wt, a, bias)
        torch.cuda.synchronize(dev)
        assert cs.launches_by_device[dev.index] == before + 1
        _close(got, cs.fused_conv_stack_plain(x, wt, a, bias))


def test_sharded_denoise_on_cards_matches_one_device(cards):
    """BSVD-32 and a 64-feature SRVGG through K1 and K4, W over four
    bands (on distinct cards where there are four, else the first card
    four times), two chunks with the state carried sharded."""
    devices = (cards if len(cards) >= 4 else cards[:1] * 4)[:4]
    dev = devices[0]
    cfg = srvgg.SRVGGConfig(num_conv=4)
    params = {"sr": srvgg.init_params(torch.Generator().manual_seed(0), cfg, dev),
              "denoise": bsvd.init_params(torch.Generator().manual_seed(1), bsvd.BSVD_32, dev)}
    params = par._bands.tree_map(lambda t: t.to(torch.bfloat16), params)
    spec = steps.UpscaleSpec(lr_shape=(64, 512), output_shape=(128, 1024), denoise_rate=0.75)

    def sr_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, cfg=cfg, conv_stack=1)

    fn = par.make_sharded_denoise(sr_apply, spec, par.make_mesh(devices=devices, spatial=4),
                                  halo=par.denoise_radius(cfg))
    rng = np.random.default_rng(2)
    state = steps.init_denoise_state(1, spec, device=dev)
    sharded = state
    with torch.inference_mode():
        for _ in range(2):
            frames = torch.from_numpy(rng.integers(0, 256, (4, 64, 512, 3), dtype=np.uint8))
            k1 = sum(tsm.launches_by_device.get(d.index, 0) for d in set(devices))
            want, state = steps.upscale_batch_denoise(sr_apply, params, state, frames.to(dev), spec)
            got, sharded = fn(params, sharded, frames)
            torch.cuda.synchronize()
            bands = len(sharded.bands)
            assert sum(tsm.launches_by_device.get(d.index, 0) for d in set(devices)) == k1 + 16 * (1 + bands)
            mse = ((got.cpu().double() - want.cpu().double()) ** 2).mean().item()
            assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= 40.0, mse


def _panning_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """n uint8 frames of a smooth random scene panning 2 px a frame."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((h // 16 + 2, (w + 2 * n) // 16 + 2, 3), dtype=np.float32))
    scene = torch.nn.functional.interpolate(coarse.permute(2, 0, 1)[None], scale_factor=16, mode="bicubic",
                                            align_corners=False)[0].permute(1, 2, 0).clamp(0, 1).numpy()
    return np.stack([(scene[:h, 2 * i : 2 * i + w] * 255).astype(np.uint8) for i in range(n)])


def test_sharded_egvsr_on_cards_matches_one_device(cards):
    """FRNet (nf 16, nb 1) W over four bands (on distinct cards where
    there are four, else the first card four times), each band's HR warp
    through K3 with its column origin: one launch a band and frame.
    Three panning frames with the state carried sharded, the third a
    scene cut, against the single-device step (its warp through K3)."""
    devices = (cards if len(cards) >= 4 else cards[:1] * 4)[:4]
    dev = devices[0]
    cfg = egvsr.EGVSRConfig(nf=16, nb=1)
    params = par._bands.tree_map(lambda t: t.to(dev, torch.bfloat16),
                                 egvsr.init_params(torch.Generator().manual_seed(0), cfg))
    spec = steps.UpscaleSpec(lr_shape=(64, 512), output_shape=(128, 1024))
    fn = par.make_sharded_egvsr_step(spec, par.make_mesh(devices=devices, spatial=4), cfg, cut_threshold=0.12)
    frames = _panning_frames(3, 64, 512, seed=4)
    frames[2] = 255 - frames[2]
    state = sharded = egvsr.init_recurrent_state(1, 64, 512, cfg, torch.bfloat16, dev)
    with torch.inference_mode():
        for i in range(3):
            frame = torch.from_numpy(frames[i : i + 1])
            want, state = steps.egvsr_upscale_step(params, state, frame.to(dev), spec, cut_threshold=0.12, cfg=cfg)
            before = wp.launches
            got, sharded = fn(params, sharded, frame)
            torch.cuda.synchronize()
            assert wp.launches == before + len(sharded.bands) == before + 4
            mse = ((got.cpu().double() - want.cpu().double()) ** 2).mean().item()
            assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= 40.0, mse
