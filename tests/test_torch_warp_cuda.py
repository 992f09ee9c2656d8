"""The CUDA kernel behind sharkshark_tpu_torch/ops/warp.py::backward_warp_fast
(K3) against its plain PyTorch version on the card, at shapes beyond the
EGVSR path's (ragged H and W, N = 2, C = 1..4, float32 and bf16 x and
flow, the NHWC and the s2d_out=4 layouts, the skip flag), and the
wrapper's refusals.  chip_smoke.py holds the kernel at the path's own
shape, (1, 2880, 5120, 3) bf16.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_cuda.py

Tolerances: the kernel samples at u + dx directly, the plain version
through the normalised grid as the JAX package does; at these widths the
two sample points differ by a few 1e-5 px, so float32 outputs agree to
atol 1e-4 on values in [0, 1).  A bf16 output may then round one ulp the
other way: atol 2^-7, two bf16 ulps below 1.0.  The skip copies x
exactly.
"""

import pytest
import torch

from sharkshark_tpu_torch.ops import space_to_depth
from sharkshark_tpu_torch.ops import warp as wp

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n, h, w, c, xdt, fdt, disp, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, h, w, c), generator=g, device=dev).to(xdt)
    flow = ((torch.rand((n, h, w, 2), generator=g, device=dev) * 2 - 1) * disp).to(fdt)
    return x, flow


@pytest.mark.parametrize("n,h,w,c,xdt,fdt,disp,s2d", [
    (1, 9, 13, 3, torch.bfloat16, torch.bfloat16, 3.0, 0),
    (2, 16, 24, 3, torch.bfloat16, torch.bfloat16, 20.0, 4),
    (1, 37, 131, 1, torch.float32, torch.float32, 40.0, 0),
    (2, 20, 28, 2, torch.float32, torch.bfloat16, 95.0, 4),
    (1, 33, 65, 4, torch.bfloat16, torch.float32, 8.0, 0),
    (3, 12, 8, 4, torch.float32, torch.float32, 150.0, 4),   # beyond every border
    (1, 64, 200, 3, torch.float32, torch.float32, 0.5, 2),
])
def test_kernel_matches_plain(dev, n, h, w, c, xdt, fdt, disp, s2d):
    x, flow = _inputs(dev, n, h, w, c, xdt, fdt, disp, seed=n * 1000 + h + w + c)
    before = wp.launches
    got = wp.backward_warp_fast(x, flow, s2d_out=s2d)
    torch.cuda.synchronize()
    assert wp.launches == before + 1
    want = wp.backward_warp_plain(x, flow, s2d_out=s2d)
    assert got.shape == want.shape and got.dtype == xdt
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[xdt])


@pytest.mark.parametrize("s2d", [0, 4])
@pytest.mark.parametrize("set_", [False, True])
def test_skip_flag(dev, s2d, set_):
    x, flow = _inputs(dev, 2, 16, 20, 3, torch.bfloat16, torch.bfloat16, 30.0, seed=7)
    skip = torch.tensor([set_], device=dev)
    got = wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip)
    torch.cuda.synchronize()
    if set_:
        assert torch.equal(got, space_to_depth(x, s2d) if s2d else x)
    else:
        want = wp.backward_warp_fast(x, flow, s2d_out=s2d)
        assert torch.equal(got, want)


def test_zero_flow_is_exact(dev):
    x, _ = _inputs(dev, 1, 15, 17, 3, torch.float32, torch.float32, 0.0, seed=8)
    got = wp.backward_warp_fast(x, torch.zeros((1, 15, 17, 2), device=dev))
    assert torch.equal(got, x)


def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    x, flow = _inputs(dev, 1, 8, 16, 3, torch.bfloat16, torch.bfloat16, 4.0, seed=9)
    before = wp.launches
    with pytest.raises(TypeError, match="float16"):
        wp.backward_warp_fast(x.half(), flow)
    with pytest.raises(TypeError, match="float64"):
        wp.backward_warp_fast(x, flow.double())
    with pytest.raises(ValueError, match="contiguous"):
        wp.backward_warp_fast(x.transpose(1, 2).contiguous().transpose(1, 2), flow)
    with pytest.raises(ValueError, match="shape"):
        wp.backward_warp_fast(x, flow[:, :4])
    with pytest.raises(ValueError, match="shape"):
        wp.backward_warp_fast(x, torch.cat([flow, flow[..., :1]], dim=-1))
    with pytest.raises(ValueError, match="channels"):
        wp.backward_warp_fast(torch.cat([x, x], dim=-1), flow)
    with pytest.raises(ValueError, match="divide"):
        wp.backward_warp_fast(x, flow, s2d_out=3)
    with pytest.raises(TypeError, match="bool"):
        wp.backward_warp_fast(x, flow, skip=torch.ones(1, device=dev))
    with pytest.raises(ValueError, match="is on"):
        wp.backward_warp_fast(x, flow.cpu())
    assert wp.launches == before
