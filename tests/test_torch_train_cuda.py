"""The training tree on the card: the routes BSVD's temporal-shift convs
take there, and the recipes' forward passes against the CPU.

- The serving `chunk_step` (shift_conv="kernel", the default) launches
  K1 on a bf16 CUDA tensor and refuses a float32 one: K1 takes bf16
  only, and nothing falls back to the library conv.
- Training's `clip_forward` takes the library route in float32 on the
  card, launches no K1, and agrees with the CPU.
- `forward_sequence` (the plain warp, no K3) agrees with the CPU.

These tests need an NVIDIA GPU (and nvcc for K1), so they carry the
`cuda` marker and skip on a host without CUDA.  On the card, without the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

Tolerance: atol 1e-4 between the card (TF32 off) and the CPU in float32,
as the CPU tests hold the port to the JAX package.
"""

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch.models import bsvd, egvsr
from sharkshark_tpu_torch.models.torch_import import to_tensors
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.train import denoise

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
