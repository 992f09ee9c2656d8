"""sharkshark_tpu_torch/ops/tsm_conv.py::tsm_conv_pair (K2, two chained
launches of K1's kernel) against its plain PyTorch version on the card,
at shapes beyond the main path's (T = 2..5, N = 1..3, ragged H and W,
all activations, no bias), against two tsm_conv calls bit for bit, and
the wrapper's refusals.  chip_smoke.py holds it at the warm chunk's own
shapes.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tsm_conv_pair_cuda.py

Tolerance: rtol = atol = 0.05 on bf16 outputs compared as float32, as
for K1: the kernel rounds y1 once after bias and act, the plain version
rounds the conv and then the bias add, so y1 may differ by a bf16 ulp,
and y2 carries that through a sum of 9*C products.  Against two tsm_conv
calls the result is exact: the same launches on the same inputs.
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


def _inputs(dev, t, n, h, w, c, seed, bias=True):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    lead = (t,) if n is None else (t, n)
    state = () if n is None else (n,)
    x = randn(*lead, h, w, c)
    carries = [randn(*state, h, w, c), randn(*state, h, w, c // 8),
               randn(*state, h, w, c), randn(*state, h, w, c // 8)]
    w1, w2 = randn(3, 3, c, c, scale=0.05), randn(3, 3, c, c, scale=0.05)
    b1, b2 = (randn(c, scale=0.1), randn(c, scale=0.1)) if bias else (None, None)
    return x, *carries, w1, b1, w2, b2


@pytest.mark.parametrize("t,n,h,w,c,act,bias", [
    (2, 1, 9, 13, 64, "relu6", True),
    (3, 2, 17, 31, 128, "relu", True),
    (4, 1, 40, 57, 64, "relu", False),
    (5, 3, 23, 18, 128, "relu6", True),
    (4, None, 20, 29, 64, "relu6", True),    # (T, H, W, C), no batch axis
    (2, None, 11, 47, 128, "relu", False),
    (4, 1, 36, 64, 64, "relu6", True),       # tiles that divide H and W evenly
    (3, 1, 21, 34, 64, "none", True),        # no activation
    (2, 2, 19, 40, 128, "none", False),
])
def test_kernel_matches_plain(dev, t, n, h, w, c, act, bias):
    args = _inputs(dev, t, n, h, w, c, seed=t * 100 + c + h, bias=bias)
    before, k1_before = tsm.pair_launches, tsm.launches
    got_y2, got_carry = tsm.tsm_conv_pair(*args, act)
    torch.cuda.synchronize()
    assert (tsm.pair_launches, tsm.launches) == (before + 1, k1_before + 2)
    want_y2, want_carry = tsm.tsm_conv_pair_plain(*args, act)
    assert got_y2.shape == want_y2.shape == args[0].shape and got_y2.dtype == torch.bfloat16
    assert got_carry.shape == want_carry.shape == (2, *args[0].shape[1:])
    torch.testing.assert_close(got_carry.float(), want_carry.float(), rtol=TOL, atol=TOL)
    torch.testing.assert_close(got_y2.float(), want_y2.float(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,n,c", [(4, 1, 64), (4, 1, 128), (3, None, 64)])
def test_pair_matches_two_single_launches(dev, t, n, c):
    """K2 against K1 twice on the same tensors (the route it stands for):
    bit for bit, y1's last two frames a contiguous view."""
    x, p1x, l0x, p1y, l0y, w1, b1, w2, b2 = _inputs(dev, t, n, 45, 80, c, seed=9)
    y2, carry = tsm.tsm_conv_pair(x, p1x, l0x, p1y, l0y, w1, b1, w2, b2, "relu6")
    y1 = tsm.tsm_conv(x, p1x, l0x, w1, b1, "relu6")
    ref = tsm.tsm_conv(y1, p1y, l0y, w2, b2, "relu6")
    assert carry.is_contiguous() and carry.shape == (2, *x.shape[1:])
    assert torch.equal(carry, y1[-2:]) and torch.equal(y2, ref)


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    args = list(_inputs(dev, 2, 1, 8, 16, 64, seed=5))
    before, k1_before = tsm.pair_launches, tsm.launches
    with pytest.raises(TypeError, match="bf16"):
        tsm.tsm_conv_pair(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="T >= 2"):
        tsm.tsm_conv_pair(args[0][:1], *args[1:])
    with pytest.raises(ValueError, match="C in"):
        tsm.tsm_conv_pair(*_inputs(dev, 2, 1, 8, 16, 24, seed=6))
    with pytest.raises(ValueError, match="shape"):
        tsm.tsm_conv_pair(args[0], args[1], args[2], args[3][..., :8, :], *args[4:])
    with pytest.raises(ValueError, match="act"):
        tsm.tsm_conv_pair(*args, "gelu")
    with pytest.raises(ValueError, match="is on"):
        tsm.tsm_conv_pair(*args[:8], args[8].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        tsm.tsm_conv_pair(args[0], args[1], args[2], args[3].transpose(1, 2).contiguous().transpose(1, 2),
                          *args[4:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsm.tsm_conv_pair(args[0], *args[1:3],
                          torch.empty(args[3].numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(args[3].shape),
                          *args[4:])
    assert (tsm.pair_launches, tsm.launches) == (before, k1_before)
