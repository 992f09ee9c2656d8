"""The CUDA kernel behind sharkshark_tpu_torch/ops/tsm_conv.py against its
plain PyTorch version on the card, at T = 1..5, N = 1 and 2, H and W that
its 16 x 16 tile does not divide, fewer tiles than SMs, the main path's
shapes (more tiles than the persistent grid), each activation and no
bias, and the wrapper's refusals.  chip_smoke.py also holds the kernel
at the main path's shapes, and times it there.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tsm_conv_cuda.py

Tolerance: rtol = atol = 0.05 on bf16 outputs compared as float32, as
chip_smoke.py and tests/test_tsm_conv.py use (one bf16 rounding of
outputs of order 1, sums of 9*C products in another order).
"""

import pytest
import torch

from sharkshark_tpu_torch.ops import tsm_conv as tsm

pytestmark = pytest.mark.cuda
TOL = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, t, n, h, w, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    lead = (t,) if n is None else (t, n)
    state = () if n is None else (n,)
    return (randn(*lead, h, w, c), randn(*state, h, w, c), randn(*state, h, w, c // 8),
            randn(3, 3, c, c, scale=0.05), randn(c, scale=0.1))


@pytest.mark.parametrize("t,n,h,w,c,act,bias", [
    (1, 1, 9, 13, 64, "relu6", True),
    (2, 2, 17, 31, 128, "relu", True),
    (3, 1, 40, 33, 64, "relu", False),
    (5, 2, 23, 18, 128, "relu6", True),
    (4, None, 20, 16, 64, "relu6", True),    # (T, H, W, C), no batch axis
    (2, None, 11, 47, 128, "relu", False),
    # H and W that the 16 x 16 tile does not divide
    (2, 1, 37, 45, 64, "relu6", True),
    (3, 1, 29, 50, 128, "relu6", True),
    # fewer tiles than SMs: one tile, one block (C=64) or one pair (C=128)
    (1, 1, 9, 13, 128, "relu6", True),
    # more tiles than the persistent grid: each block walks many tiles
    (4, 1, 360, 640, 64, "relu6", True),
    (4, 1, 180, 320, 128, "relu6", True),
    # N=2 with no bias and each activation
    (2, 2, 33, 70, 64, "none", False),
    (3, 2, 21, 19, 128, "none", False),
    (2, 2, 40, 66, 64, "relu", False),
    (2, 2, 17, 35, 128, "relu6", False),
])
def test_kernel_matches_plain(dev, t, n, h, w, c, act, bias):
    x, prev1, left0, wt, b = _inputs(dev, t, n, h, w, c, seed=t * 100 + c + h)
    b = b if bias else None
    before = tsm.launches
    got = tsm.tsm_conv(x, prev1, left0, wt, b, act)
    torch.cuda.synchronize()
    assert tsm.launches == before + 1
    want = tsm.tsm_conv_plain(x, prev1, left0, wt, b, act)
    assert got.shape == want.shape == x.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL, atol=TOL)


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    x, prev1, left0, wt, b = _inputs(dev, 2, 1, 8, 16, 64, seed=5)
    before = tsm.launches
    with pytest.raises(TypeError, match="bf16"):
        tsm.tsm_conv(x.float(), prev1, left0, wt, b)
    with pytest.raises(ValueError, match="C in"):
        x24, p24, l24, w24, b24 = _inputs(dev, 2, 1, 8, 16, 24, seed=6)
        tsm.tsm_conv(x24, p24, l24, w24, b24)
    with pytest.raises(ValueError, match="contiguous"):
        tsm.tsm_conv(x.transpose(2, 3).contiguous().transpose(2, 3), prev1, left0, wt, b)
    with pytest.raises(ValueError, match="shape"):
        tsm.tsm_conv(x, prev1[..., :8, :], left0, wt, b)
    with pytest.raises(ValueError, match="act"):
        tsm.tsm_conv(x, prev1, left0, wt, b, "gelu")
    assert tsm.launches == before
