"""The CUDA kernel behind sharkshark_tpu_torch/ops/warp.py::backward_warp_fast
(K3) against its plain PyTorch version on the card, at shapes beyond the
EGVSR path's (ragged H and W, widths that no pixel group divides, N = 2,
C = 1..4, float32 and bf16 x and flow, the NHWC, s2d_out=2 and s2d_out=4
layouts, the skip flag, every tap on the tensor's last pixel), a column
origin (a band of the whole frame's warp, as the width-sharded EGVSR step
asks for), and the wrapper's refusals.  chip_smoke.py holds the kernel at
the path's own shapes, (1, 2880, 5120, 3) bf16 and the 1x4 mesh's bands
of it.

These tests need an NVIDIA GPU and nvcc, so they carry the `cuda` marker
and skip on a host without CUDA.  On the card, without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_cuda.py

Tolerances: the kernel samples at u + dx directly, the plain version
through the normalised grid as the JAX package does; at these widths the
two sample points differ by a few 1e-5 px, so float32 outputs agree to
atol 1e-4 on values in [0, 1).  A bf16 output may then round one ulp the
other way: atol 2^-7, two bf16 ulps below 1.0.  The skip copies x
exactly.  A band's warp (an origin) is held to K3's bound, 2^-8 in bf16
(one ulp below 1.0), and equals the whole frame's kernel output at its
columns bit for bit.
"""

import pytest
import torch

from sharkshark_tpu_torch.ops import space_to_depth
from sharkshark_tpu_torch.ops import warp as wp

pytestmark = pytest.mark.cuda
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7}
BAND_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-8}


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


DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,h,w,c", [
    (1, 7, 13, 3),    # a warp owns 128 (bf16) or 64 (float32) pixels: no row here is whole spans
    (2, 5, 37, 3),
    (1, 3, 131, 1),
    (3, 2, 2, 3),     # a group spans all three images, and the tensor's end cuts it
])
def test_widths_no_pixel_group_divides(dev, xdt, n, h, w, c):
    x, flow = _inputs(dev, n, h, w, c, xdt, torch.bfloat16, 12.0, seed=w + c)
    got = wp.backward_warp_fast(x, flow)
    torch.cuda.synchronize()
    want = wp.backward_warp_plain(x, flow)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[xdt])


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("s2d", [0, 2, 4])
def test_every_tap_at_the_last_pixel(dev, xdt, c, s2d):
    """A flow that sends every pixel past the bottom-right corner: all four
    taps read the tensor's last pixel, where a vector load of the
    neighbour pair would run past x's end; and one that lands a pixel left
    of it, so that the pair is the last two pixels."""
    n, h, w = 2, 8, 12
    x, _ = _inputs(dev, n, h, w, c, xdt, torch.float32, 0.0, seed=c)
    u = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]
    v = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    for dx, dy in ((1e4 - u, 1e4 - v), (w - 1.5 - u, h - 1.25 - v)):
        flow = torch.stack([dx.expand(n, h, w), dy.expand(n, h, w)], dim=-1)
        got = wp.backward_warp_fast(x, flow, s2d_out=s2d)
        torch.cuda.synchronize()
        want = wp.backward_warp_plain(x, flow, s2d_out=s2d)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[xdt])


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("fdt", DTYPES)
@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("n,s2d", [(1, 0), (2, 2), (2, 4)])
def test_channels_layouts_and_batches(dev, xdt, fdt, c, n, s2d):
    x, flow = _inputs(dev, n, 16, 24, c, xdt, fdt, 20.0, seed=10 * c + n + s2d)
    got = wp.backward_warp_fast(x, flow, s2d_out=s2d)
    torch.cuda.synchronize()
    want = wp.backward_warp_plain(x, flow, s2d_out=s2d)
    assert got.shape == want.shape and got.dtype == xdt
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[xdt])


def test_wrapper_refuses_what_the_vector_kernel_cannot_take(dev):
    """The kernel reads by aligned 16-byte vectors and is built for
    s2d_out 0, 2 and 4: a misaligned x or flow, and s2d_out = 8, raise."""
    x, flow = _inputs(dev, 1, 8, 16, 3, torch.bfloat16, torch.bfloat16, 4.0, seed=9)
    before = wp.launches
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    f_off = torch.empty(flow.numel() + 2, dtype=flow.dtype, device=dev)[2:].view(flow.shape)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        wp.backward_warp_fast(x_off, flow)
    with pytest.raises(ValueError, match="flow must be 16-byte aligned"):
        wp.backward_warp_fast(x, f_off)
    with pytest.raises(ValueError, match="s2d_out in"):
        wp.backward_warp_fast(x, flow, s2d_out=8)
    assert wp.launches == before


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


# origins of a 20-column band in a 52-wide frame: at 0, inside, and flush
# with the frame's right edge
ORIGINS = {"zero": 0, "middle": 16, "flush": 32}


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("c,s2d", [(1, 0), (2, 1), (3, 4), (4, 2), (3, 0), (1, 4)])
@pytest.mark.parametrize("fdt", DTYPES)
@pytest.mark.parametrize("xdt", DTYPES)
def test_column_origin_matches_plain(dev, xdt, fdt, c, s2d, origin):
    """Columns [col0, col0 + 20) of a 52-wide frame's warp along a flow of
    up to +-30 px, which leaves the band and the frame: against the plain
    version within BAND_ATOL, and the whole frame's kernel output at
    those columns bit for bit."""
    col0, wo = ORIGINS[origin], 20
    x, flow = _inputs(dev, 2, 16, 52, c, xdt, fdt, 30.0, seed=100 * c + 10 * s2d + col0)
    band = flow[:, :, col0 : col0 + wo].contiguous()
    before = wp.launches
    got = wp.backward_warp_fast(x, band, s2d_out=s2d, col0=col0)
    torch.cuda.synchronize()
    assert wp.launches == before + 1
    want = wp.backward_warp_plain(x, band, s2d_out=s2d, col0=col0)
    assert got.shape == want.shape and got.dtype == xdt
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=BAND_ATOL[xdt])
    whole = wp.backward_warp_fast(x, flow)[:, :, col0 : col0 + wo]
    assert torch.equal(got, space_to_depth(whole, s2d) if s2d else whole)


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("s2d", [0, 2, 4])
def test_band_at_the_right_edge_reads_the_last_pixel(dev, xdt, c, s2d):
    """A band flush with the frame's right edge, along flows that send
    every tap to the tensor's last pixel, or a pixel left of it (the
    guarded span loads near x's end), with the skip unset and set (then
    x's columns, exactly)."""
    n, h, w, col0, wo = 2, 8, 28, 16, 12
    x, _ = _inputs(dev, n, h, w, c, xdt, torch.float32, 0.0, seed=c + s2d)
    u = torch.arange(col0, w, device=dev, dtype=torch.float32)[None, None, :]
    v = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    for dx, dy in ((1e4 - u, 1e4 - v), (w - 1.5 - u, h - 1.25 - v)):
        flow = torch.stack([dx.expand(n, h, wo), dy.expand(n, h, wo)], dim=-1).contiguous()
        for skip in (None, torch.tensor([False], device=dev), torch.tensor([True], device=dev)):
            got = wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip, col0=col0)
            torch.cuda.synchronize()
            want = wp.backward_warp_plain(x, flow, s2d_out=s2d, skip=skip, col0=col0)
            if skip is not None and bool(skip):
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=BAND_ATOL[xdt])


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("s2d", [0, 4])
def test_origin_zero_is_the_call_without_one(dev, xdt, s2d):
    x, flow = _inputs(dev, 1, 16, 40, 3, xdt, torch.bfloat16, 20.0, seed=11)
    assert torch.equal(wp.backward_warp_fast(x, flow, s2d_out=s2d, col0=0), wp.backward_warp_fast(x, flow, s2d_out=s2d))


def test_wrapper_refuses_a_band_outside_x(dev):
    x, flow = _inputs(dev, 1, 8, 16, 3, torch.bfloat16, torch.bfloat16, 4.0, seed=9)
    band = flow[:, :, :8].contiguous()
    before = wp.launches
    with pytest.raises(ValueError, match="must lie in"):
        wp.backward_warp_fast(x, band, col0=9)
    with pytest.raises(ValueError, match="must lie in"):
        wp.backward_warp_fast(x, band, col0=-1)
    with pytest.raises(ValueError, match="must divide"):
        wp.backward_warp_fast(x, flow[:, :, :6].contiguous(), s2d_out=4, col0=2)
    assert wp.launches == before
