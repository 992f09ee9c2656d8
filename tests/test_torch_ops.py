"""The PyTorch port's plain ops (sharkshark_tpu_torch/ops) against the JAX
package's, on the same numpy inputs made from a fixed seed, on the CPU.

Tolerance: float32 on both sides, atol 1e-5 (the two differ only in the
order of float32 sums); uint8 outputs must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.ops import color as jcolor
from sharkshark_tpu.ops import fused_epilogue as jfe
from sharkshark_tpu.ops import nn as jnn
from sharkshark_tpu.ops.resize import resize as jresize
from sharkshark_tpu_torch.ops import color, nn
from sharkshark_tpu_torch.ops import fused_epilogue as fe
from sharkshark_tpu_torch.ops.resize import resize

ATOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("method,src,dst", [
    ("area", (36, 64), (18, 32)),     # integer factor: reshape + mean
    ("area", (36, 64), (24, 40)),     # non-integer windows
    ("bilinear", (9, 16), (36, 64)),
    ("bilinear", (36, 64), (20, 30)),
    ("bicubic", (18, 32), (36, 64)),
    ("bicubic", (36, 64), (27, 48)),
    ("nearest", (9, 16), (36, 64)),
    ("nearest", (36, 64), (20, 24)),
])
def test_resize_matches_jax(method, src, dst):
    x = _rand(2, *src, 3, seed=1)
    _close(resize(_t(x), dst, method), jresize(jnp.asarray(x), dst, method))


@pytest.mark.parametrize("method", ["area", "bilinear", "bicubic", "nearest"])
def test_resize_same_size_is_identity(method):
    x = _t(_rand(1, 8, 12, 3))
    assert resize(x, (8, 12), method) is x


def test_to_uint8_truncates_like_jax():
    x = np.array([-0.1, 0.0, 0.5 / 255, 1.9 / 255, 127.99 / 255, 254.99 / 255, 1.0, 1.2], np.float32)
    got = color.to_uint8(_t(x)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 127, 254, 255, 255])
    np.testing.assert_array_equal(got, np.asarray(jcolor.to_uint8(jnp.asarray(x))))
    frames = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    _close(color.to_float(_t(frames)), jcolor.to_float(jnp.asarray(frames)), atol=0)


def test_to_yuv420_matches_jax():
    x = _rand(2, 16, 24, 3, seed=3)
    got = color.to_yuv420(_t(x)).numpy()
    assert got.shape == (2, 24, 24) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jcolor.to_yuv420(jnp.asarray(x))))


@pytest.mark.parametrize("strength", [0.00002, 0.00007, 0.5])
def test_sharpen_matches_jax(strength):
    x = _rand(2, 12, 20, 3, seed=4)
    _close(color.sharpen(_t(x), strength), jcolor.sharpen(jnp.asarray(x), strength))


@pytest.mark.parametrize("size,sigma", [(3, 0.5), (17, 8.0)])
def test_blur_matches_jax(size, sigma):
    x = _rand(2, 24, 32, 3, seed=5)
    _close(color.blur(_t(x), size, sigma), jcolor.blur(jnp.asarray(x), size, sigma))


def test_global_color_match_matches_jax():
    hr = _rand(2, 24, 40, 3, seed=6)
    lr = _rand(2, 12, 20, 3, seed=7, scale=0.5)
    _close(color.global_color_match(_t(hr), _t(lr)),
           jcolor.global_color_match(jnp.asarray(hr), jnp.asarray(lr)))


def test_local_color_match_matches_jax():
    hr = _rand(1, 144, 160, 3, seed=8)
    lr = _rand(1, 72, 80, 3, seed=9)
    got = color.local_color_match(_t(hr), _t(lr))
    want = jcolor.local_color_match(jnp.asarray(hr), jnp.asarray(lr))
    assert not np.allclose(got.numpy(), hr)  # the match is active at this size
    _close(got, want)
    small = _t(hr[:, :48, :48])  # below the blur support: identity
    assert color.local_color_match(small, _t(lr)) is small


@pytest.mark.parametrize("num,den,h,w", [(2, 1, 6, 10), (3, 2, 6, 9)])
def test_rational_epilogue_matches_jax(num, den, h, w):
    y = _rand(2, h, w, 48, seed=10)
    x = _rand(2, h, w, 3, seed=11)
    got = fe.ps4_bicubic_down_rational(_t(y), num, den)
    assert got.shape == (2, 4 * h * den // num, 4 * w * den // num, 3)
    _close(got, jfe.ps4_bicubic_down_rational(jnp.asarray(y), num, den))
    _close(fe.nearest4_bicubic_down_rational(_t(x), num, den),
           jfe.nearest4_bicubic_down_rational(jnp.asarray(x), num, den))
    assert fe._rational_plan(num, den) == jfe._rational_plan(num, den)


def test_pixel_shuffle_matches_torch_order():
    x = _rand(2, 3, 5, 3 * 16, seed=12)
    got = nn.pixel_shuffle(_t(x), 4)
    want = torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnn.pixel_shuffle(jnp.asarray(x), 4)))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_prelu_relu6_match_jax(stride):
    x = _rand(2, 12, 16, 8, seed=13) - 0.5
    w = _rand(3, 3, 8, 16, seed=14) - 0.5
    b = _rand(16, seed=15)
    alpha = _rand(16, seed=16)
    got = nn.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=1)
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=1)
    _close(got, want)
    _close(nn.prelu(got, _t(alpha)), jnn.prelu(want, jnp.asarray(alpha)))
    _close(nn.relu6(got * 8), jnn.relu6(want * 8))
