"""The CUDA kernel behind sharkshark_tpu_torch/ops/conv_stack.py (K4)
against its plain PyTorch version on the card: L = 1..L_MAX layers, with
and without bias, at image sizes that no tile divides (N > 1), and the
wrapper's refusals.  chip_smoke.py holds the kernel at SRVGG's own shape.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_conv_stack_cuda.py

Tolerance: 0.02 x max(|ref|max, 1), as experiments/tests/test_pallas_conv.py
holds the Pallas kernel: both sides round each layer to bf16 once, from
f32 sums of 9*64 products taken in another order, and a value one ulp
apart feeds the next layer.
"""

import pytest
import torch

from sharkshark_tpu_torch.ops import conv_stack as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n_layers, n, h, w, seed, bias=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, h, w, 64), generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn((n_layers, 3, 3, 64, 64), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    a = torch.linspace(0.1, 0.4, n_layers * 64, device=dev).reshape(n_layers, 64)
    b = torch.randn((n_layers, 64), generator=g, device=dev) * 0.1 if bias else None
    return x, wt, a, b


@pytest.mark.parametrize("n_layers", list(range(1, cs.L_MAX + 1)))
@pytest.mark.parametrize("n,h,w,bias", [
    (1, 45, 80, False),
    (2, 37, 53, True),
    (3, 9, 7, True),       # smaller than one tile
    (1, 100, 131, True),
])
def test_kernel_matches_plain(dev, n_layers, n, h, w, bias):
    x, wt, a, b = _inputs(dev, n_layers, n, h, w, seed=n_layers * 10 + h, bias=bias)
    before = cs.launches
    got = cs.fused_conv_stack(x, wt, a, b)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    want = cs.fused_conv_stack_plain(x, wt, a, b)
    assert got.shape == want.shape == x.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    x, wt, a, b = _inputs(dev, 2, 1, 16, 16, seed=1)
    before = cs.launches
    with pytest.raises(TypeError, match="bf16"):
        cs.fused_conv_stack(x.float(), wt, a, b)
    with pytest.raises(ValueError, match="L <="):
        x5, w5, a5, b5 = _inputs(dev, cs.L_MAX + 1, 1, 16, 16, seed=2)
        cs.fused_conv_stack(x5, w5, a5, b5)
    with pytest.raises(ValueError, match="x must be"):
        cs.fused_conv_stack(x[..., :48], wt, a, b)
    with pytest.raises(ValueError, match="contiguous"):
        cs.fused_conv_stack(x.transpose(1, 2), wt, a, b)
    with pytest.raises(ValueError, match="bias"):
        cs.fused_conv_stack(x, wt, a, b[:1])
    assert cs.launches == before
