"""The CUDA kernel behind sharkshark_tpu_torch/ops/conv_stack.py (K4)
against its plain PyTorch version on the card: L = 1..L_MAX layers (L
chained launches of the one-layer kernel), with and without bias, at
image sizes that no tile divides (N > 1); one layer at SRVGG's body
shape, at the tile path's ragged 276 x 276 tile and with fewer tiles
than SMs; its grid (never more blocks than tiles, the same at every
depth); the scratch buffer of the chained layers; and the wrapper's and
the C interface's refusals.  chip_smoke.py holds the kernel at SRVGG's
own shape too.

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
    assert cs.launches == before + n_layers  # one launch a layer
    want = cs.fused_conv_stack_plain(x, wt, a, b)
    assert got.shape == want.shape == x.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("n,h,w,bias", [
    (4, 720, 1280, True),   # SRVGG's body at 720p, micro-batch 4
    (4, 720, 1280, False),
    (1, 276, 276, True),    # a tile_upscale tile: 256 + 2 x 10 pad, 17.25 tiles a side
    (1, 40, 60, True),      # 12 tiles, fewer than SMs
    (2, 64, 100, False),    # 56 tiles over two images
])
def test_one_layer_matches_plain(dev, n, h, w, bias):
    x, wt, a, b = _inputs(dev, 1, n, h, w, seed=h + w, bias=bias)
    tiles, blocks = cs.kernel_schedule(n, h, w)
    assert tiles == n * -(-h // 16) * -(-w // 16)
    assert 1 <= blocks <= min(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    before = cs.launches
    got = cs.fused_conv_stack(x, wt, a, b)
    torch.cuda.synchronize()
    assert cs.launches == before + 1
    want = cs.fused_conv_stack_plain(x, wt, a, b)
    assert got.shape == want.shape == x.shape and got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (3, 9, 7), (1, 16, 16), (4, 720, 1280), (64, 16, 16)])
def test_schedule_never_launches_more_blocks_than_tiles(dev, n, h, w):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_layers in range(1, cs.L_MAX + 1):
        tiles, blocks = cs.kernel_schedule(n, h, w, n_layers)
        assert 1 <= blocks <= tiles, (n_layers, tiles, blocks)
        if n_layers == 1:
            assert blocks == min(tiles, sms)


@pytest.mark.parametrize("n,h,w", [(1, 9, 7), (4, 720, 1280), (64, 16, 16)])
def test_schedule_is_the_one_layer_grid_at_every_depth(dev, n, h, w):
    one = cs.kernel_schedule(n, h, w, 1)
    assert [cs.kernel_schedule(n, h, w, L) for L in range(2, cs.L_MAX + 1)] == [one] * (cs.L_MAX - 1)


@pytest.mark.parametrize("n_layers", list(range(1, cs.L_MAX + 1)))
def test_scratch_never_aliases_x_or_out(dev, monkeypatch, n_layers):
    """The chained layers ping-pong between out and one scratch buffer:
    the wrapper passes a scratch buffer of x's size apart from x and out
    at L > 1 (none at L = 1), and the C interface refuses one that is x
    or out, or none, without launching."""
    x, wt, a, b = _inputs(dev, n_layers, 2, 20, 24, seed=n_layers)
    stack, sched = cs._kernel_fns()
    calls = []

    def spy(*args):
        calls.append(args)
        return stack(*args)

    monkeypatch.setattr(cs, "_kernel_fns", lambda: (spy, sched))
    got = cs.fused_conv_stack(x, wt, a, b)
    torch.cuda.synchronize()
    (args,) = calls
    x_ptr, out_ptr, scratch_ptr = args[0], args[4], args[5]
    assert x_ptr == x.data_ptr() and out_ptr == got.data_ptr()
    size = x.numel() * x.element_size()
    if n_layers == 1:
        assert scratch_ptr == 0
    else:
        for other in (x_ptr, out_ptr):
            assert scratch_ptr + size <= other or other + size <= scratch_ptr, "scratch overlaps x or out"
    want = cs.fused_conv_stack_plain(x, wt, a, b).float()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=0.02 * max(want.abs().max().item(), 1.0))

    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), wt.data_ptr(), b.data_ptr(), a.data_ptr())
    bad = [(x.data_ptr(), 0), (x.data_ptr(), out.data_ptr())]  # out = x, with and without a scratch
    if n_layers > 1:
        bad += [(out.data_ptr(), 0), (out.data_ptr(), x.data_ptr()), (out.data_ptr(), out.data_ptr())]
    for out_ptr, scratch_ptr in bad:
        assert stack(*ptrs, out_ptr, scratch_ptr, 2, 20, 24, n_layers, stream) != 0, (out_ptr, scratch_ptr)


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
