"""The training tree on the card: the routes BSVD's temporal-shift convs
take there, and the recipes' forward passes against the CPU.

- The serving `chunk_step` (shift_conv="kernel", the default) launches
  K1 on a bf16 CUDA tensor and refuses a float32 one: K1 takes bf16
  only, and nothing falls back to the library conv.
- Training's `clip_forward` takes the library route in float32 on the
  card, launches no K1, and agrees with the CPU.
- `forward_sequence` (the plain warp, no K3) agrees with the CPU.
- The GAN recipe's losses, gradients and one whole step (the plain warp,
  no K3) agree with the CPU, and so do the ESPCN, VESPCN and SOF-VSR
  generators.

These tests need an NVIDIA GPU (and nvcc for K1), so they carry the
`cuda` marker and skip on a host without CUDA.  On the card, without the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

Tolerance: atol 1e-4 between the card (TF32 off) and the CPU in float32,
as the CPU tests hold the port to the JAX package.  The GAN step's
losses and gradients are held in float64 on both devices (losses rel
1e-9, gradient leaves ||card - cpu|| / ||cpu|| <= 1e-6): its seeded nets
amplify, and cuDNN's float32 convs round far enough from the CPU's
(~1e-3 on some gradient leaves) that float32 says little about the port.
The variants are held by PSNR (>= 55 dB), as chip_smoke holds them.
"""

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch.models import bsvd, egvsr, variants
from sharkshark_tpu_torch.models.torch_import import to_tensors
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.train import denoise, vsr, vsrgan
from sharkshark_tpu_torch.train import discriminators as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old


def _clip(seed, t=4, h=32, w=32):
    return torch.from_numpy(np.random.default_rng(seed).random((t, 1, h, w, 4), dtype=np.float32))


def test_serving_chunk_step_refuses_float32_on_the_card(dev):
    params = to_tensors(bsvd.init_params(torch.Generator().manual_seed(0)), dev)
    state = bsvd.init_chunk_state(1, 32, 32, device=dev)
    before = tsm.launches
    with pytest.raises(TypeError, match="bf16"):
        bsvd.chunk_step(params, state, _clip(1).to(dev))
    assert tsm.launches == before


def test_serving_chunk_step_launches_k1_in_bf16(dev):
    params = to_tensors(bsvd.init_params(torch.Generator().manual_seed(0)), dev, torch.bfloat16)
    state = bsvd.init_chunk_state(1, 32, 32, dtype=torch.bfloat16, device=dev)
    before = tsm.launches
    y, _ = bsvd.chunk_step(params, state, _clip(1).to(dev, torch.bfloat16))
    assert tsm.launches == before + bsvd.SHIFT_NUM
    assert torch.isfinite(y.float()).all()


def test_clip_forward_takes_the_library_route_on_the_card(dev):
    params = bsvd.init_params(torch.Generator().manual_seed(0))
    x = _clip(2)
    before = tsm.launches
    got = denoise.clip_forward(to_tensors(params, dev), x.to(dev))
    assert tsm.launches == before
    want = denoise.clip_forward(params, x)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_clip_forward_gradients_on_the_card(dev):
    params = to_tensors(bsvd.init_params(torch.Generator().manual_seed(0)), dev)
    leaf = params["temp1"]["down0_mem"]["c1"]["w"].requires_grad_(True)
    denoise.clip_forward(params, _clip(3).to(dev)).sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


def test_forward_sequence_on_the_card_matches_the_cpu(dev):
    cfg = egvsr.EGVSRConfig(nf=16, nb=2)
    params = egvsr.init_params(torch.Generator().manual_seed(0), cfg)
    lr = torch.from_numpy(np.random.default_rng(4).random((2, 3, 16, 24, 3), dtype=np.float32))
    before = wp.launches
    got = egvsr.forward_sequence(to_tensors(params, dev), lr.to(dev), cfg=cfg)
    assert wp.launches == before
    want = egvsr.forward_sequence(params, lr, cfg=cfg)
    for k in ("hr_data", "lr_flow"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)


def _rel(a, b):
    return float((a.detach().cpu().double() - b.detach().double()).norm() / b.detach().double().norm().clamp(min=1e-30))


def _cast(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dev, dtype) for v in tree]
    return tree.detach().to(dev, dtype).requires_grad_(True)


@pytest.mark.parametrize("disc_type", ["spatio_temporal", "spatial"])
def test_gan_step_on_the_card_matches_the_cpu(dev, disc_type):
    """The D and G losses and every gradient leaf in float64 on the card
    against the CPU (cuDNN's float32 algorithms round ~1e-3 apart from
    the CPU's on the recurrence's ill-conditioned leaves, so float32 is
    held by a whole step only); then one float32 step on each: the same D
    decision, finite parameters, and no K3 launch (the plain warp)."""
    cfg = vsrgan.VSRGANConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=1), disc_type=disc_type,
                              disc_cfg=D.DiscriminatorConfig(spatial_size=32, use_cond=True), lr_g=1e-3, lr_d=1e-3)
    rng = np.random.default_rng(5)
    lr = torch.from_numpy(rng.random((2, 4, 8, 8, 3), dtype=np.float32))
    gt = torch.from_numpy(rng.random((2, 4, 32, 32, 3), dtype=np.float32))
    seeded = vsrgan.create_gan_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    grads, logs = {}, {}
    for d in ("cpu", dev):
        pg, pd = _cast(seeded.params_g, d, torch.float64), _cast(seeded.params_d, d, torch.float64)
        losses = vsrgan.make_gan_loss_fns(cfg)
        ctx = losses.prepare(pg, lr.to(d, torch.float64), gt.to(d, torch.float64))
        loss_d, aux = losses.d_loss(pd, ctx)
        g_d = torch.autograd.grad(loss_d, vsr.param_leaves(pd), allow_unused=True)
        loss_g, _ = losses.g_loss(pg, pd, ctx, aux)
        g_g = torch.autograd.grad(loss_g, vsr.param_leaves(pg), allow_unused=True)
        grads[d] = [g for g in g_d + g_g if g is not None]
        logs[d] = (float(loss_d.detach()), float(loss_g.detach()), bool(aux["distance"] < cfg.update_threshold))
    assert logs[dev][2] == logs["cpu"][2]
    np.testing.assert_allclose(logs[dev][:2], logs["cpu"][:2], rtol=1e-9)
    assert max(_rel(a, b) for a, b in zip(grads[dev], grads["cpu"])) <= 1e-6

    states = {d: vsrgan.create_gan_state(torch.Generator().manual_seed(0), cfg, device=d) for d in ("cpu", dev)}
    launches = wp.launches
    for d, state in states.items():
        vsrgan.make_gan_train_step(cfg)(state, lr.to(d), gt.to(d))
    assert wp.launches == launches  # training runs the plain warp, no K3
    assert states[dev].cnt_upd_d == states["cpu"].cnt_upd_d
    assert all(torch.isfinite(t).all() for t in vsr.param_leaves(states[dev].params_g))


@pytest.mark.parametrize("name", ["espcn", "vespcn", "sofvsr"])
def test_variant_on_the_card_matches_the_cpu(dev, name):
    """Float32 outputs, the card against the CPU, by PSNR over the CPU
    output's peak: >= 55 dB with the CPU output's std >= 0.05, chip_smoke
    phase 13's bar.  (Their warps compute coordinates and taps in float32
    in any dtype, as the JAX package's do; with SOF-VSR's seeded flows of
    ~70 px a one-ulp difference there grows to ~1e-4 of the output's
    peak, so no element-wise bound holds across devices, even in
    float64.)"""
    init, apply, shape = {
        "espcn": (variants.espcn_init, variants.espcn_apply, (2, 24, 40, 1)),
        "vespcn": (variants.vespcn_init, variants.vespcn_apply, (3, 24, 40, 1)),
        "sofvsr": (variants.sofvsr_init, variants.sofvsr_apply, (1, 24, 40, 3)),
    }[name]
    params = init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).random(shape, dtype=np.float32))
    with torch.no_grad():
        got = apply(to_tensors(params, dev), x.to(dev)).cpu().double()
        want = apply(params, x).double()
    assert got.shape == want.shape and float(want.std()) >= 0.05
    mse = float(((got - want) ** 2).mean())
    assert mse == 0 or 10 * np.log10(float(want.abs().max()) ** 2 / mse) >= 55.0
