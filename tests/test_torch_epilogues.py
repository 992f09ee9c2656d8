"""The port's integer-ratio fused epilogues (ops/fused_epilogue.py:
ps4_bicubic_down{2,3,4}, nearest4_bicubic_down{2,3,4}, K), SRVGG's
apply_down / apply_down2 and the ops depthwise_conv2d,
sharpen_kernel_2d, resize_nchw and models.cast_params, against the JAX
package's functions on the same numpy inputs, on the CPU in float32.

Tolerances: the epilogues and ops at atol 1e-5 (float32 sums taken in
another order); apply_down at atol 1e-4, as the models' tests hold
SRVGG (a stack of convs); exact where the functions are (the tap
tables, the casts, the d=3 and d=4 subsample and channel mix against the
port's own bicubic resize of the 4x image)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu import models as jmodels
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.ops import color as jcolor
from sharkshark_tpu.ops import fused_epilogue as jfe
from sharkshark_tpu.ops import nn as jnn
from sharkshark_tpu.ops.resize import resize_nchw as jresize_nchw
from sharkshark_tpu_torch import models
from sharkshark_tpu_torch.models import srvgg
from sharkshark_tpu_torch.ops import color, nn
from sharkshark_tpu_torch.ops import fused_epilogue as fe
from sharkshark_tpu_torch.ops.resize import resize, resize_nchw

ATOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_tap_table_is_the_jax_packages():
    np.testing.assert_array_equal(fe.K, jfe.K)
    assert fe.K.dtype == jfe.K.dtype == np.float32


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("h,w", [(6, 9), (3, 12)])
def test_integer_epilogues_match_jax(d, h, w):
    y, x = _rand(2, h, w, 48, seed=d), _rand(2, h, w, 3, seed=10 + d)
    ps, near = getattr(fe, f"ps4_bicubic_down{d}"), getattr(fe, f"nearest4_bicubic_down{d}")
    jps, jnear = getattr(jfe, f"ps4_bicubic_down{d}"), getattr(jfe, f"nearest4_bicubic_down{d}")
    got = ps(_t(y))
    assert got.shape == (2, 4 * h // d, 4 * w // d, 3)
    _close(got, jps(jnp.asarray(y)))
    _close(near(_t(x)), jnear(jnp.asarray(x)))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_integer_epilogues_keep_the_jax_dtypes_in_bf16(d):
    """d=2 and d=4 compute in float32 for a bf16 input, as the JAX
    functions do (their K is a float32 array); d=3 slices, keeping bf16."""
    y = _rand(1, 6, 6, 48, seed=20)
    got = getattr(fe, f"ps4_bicubic_down{d}")(_t(y).bfloat16())
    want = getattr(jfe, f"ps4_bicubic_down{d}")(jnp.asarray(y, jnp.bfloat16))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-2)


@pytest.mark.parametrize("d", [3, 4])
def test_integer_epilogues_equal_the_bicubic_resize_of_the_4x_image(d):
    """d=3 (a subsample) and d=4 (a channel mix) are exact compositions of
    pixel_shuffle(4) and the port's bicubic resize."""
    y = _rand(1, 6, 9, 48, seed=30 + d)
    want = resize(nn.pixel_shuffle(_t(y), 4), (24 // d, 36 // d), "bicubic")
    torch.testing.assert_close(getattr(fe, f"ps4_bicubic_down{d}")(_t(y)), want, rtol=0, atol=ATOL)


def _srvgg(num_feat, num_conv, seed):
    cfg, jcfg = srvgg.SRVGGConfig(num_feat=num_feat, num_conv=num_conv), jsrvgg.SRVGGConfig(
        num_feat=num_feat, num_conv=num_conv)
    tp = srvgg.init_params(torch.Generator().manual_seed(seed), cfg)
    return cfg, jcfg, tp, jax.tree.map(lambda a: jnp.asarray(a.numpy()), tp)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("num_feat,conv_stack", [(16, 0), (64, 1)])
def test_apply_down_matches_jax(d, num_feat, conv_stack):
    """apply_down at each ratio, layer by layer and with the body through
    K4's wrapper (its plain version on the CPU), against the JAX
    package's XLA body."""
    cfg, jcfg, tp, jp = _srvgg(num_feat, 2, seed=d)
    x = np.random.default_rng(40 + d).random((2, 6, 9, 3), dtype=np.float32)
    got = srvgg.apply_down(tp, _t(x), d, cfg=cfg, conv_stack=conv_stack)
    assert got.shape == (2, 24 // d, 36 // d, 3)
    _close(got, jsrvgg.apply_down(jp, jnp.asarray(x), d, cfg=jcfg), atol=1e-4)
    if d == 2:
        _close(srvgg.apply_down2(tp, _t(x), cfg=cfg, conv_stack=conv_stack),
               jsrvgg.apply_down2(jp, jnp.asarray(x), cfg=jcfg), atol=1e-4)
        assert torch.equal(srvgg.apply_down2(tp, _t(x), cfg=cfg), srvgg.apply_down(tp, _t(x), 2, cfg=cfg))


def test_apply_down_refuses_what_the_jax_function_refuses():
    cfg, _, tp, _ = _srvgg(16, 1, seed=0)
    x = torch.rand(1, 6, 9, 3)
    with pytest.raises(AssertionError):
        srvgg.apply_down(tp, x, 5, cfg=cfg)
    with pytest.raises(AssertionError):
        srvgg.apply_down(tp, x, 2, cfg=cfg._replace(upscale=2))
    with pytest.raises(AssertionError):
        srvgg.apply_down(tp, x, 2, cfg=cfg._replace(num_out_ch=1))
    with pytest.raises(AssertionError):  # d=3 needs H, W divisible by 3
        srvgg.apply_down(tp, torch.rand(1, 4, 9, 3), 3, cfg=cfg)


@pytest.mark.parametrize("k,per_channel,padding,pad_mode", [
    (3, False, 1, "reflect"), (3, True, 1, "zero"), (3, True, 0, "zero"), (5, True, 2, "reflect"),
    (5, False, 2, "replicate"),
])
def test_depthwise_conv2d_matches_jax(k, per_channel, padding, pad_mode):
    x = _rand(2, 10, 14, 3, seed=50)
    wt = _rand(k, k, 1, 3 if per_channel else 1, seed=51)
    got = nn.depthwise_conv2d(_t(x), _t(wt), padding=padding, pad_mode=pad_mode)
    _close(got, jnn.depthwise_conv2d(jnp.asarray(x), jnp.asarray(wt), padding=padding, pad_mode=pad_mode))


@pytest.mark.parametrize("strength", [0.00002, 0.5, 1.0])
def test_sharpen_kernel_2d_is_the_jax_packages(strength):
    k = color.sharpen_kernel_2d(strength)
    np.testing.assert_array_equal(k, jcolor.sharpen_kernel_2d(strength))
    assert k.shape == (3, 3, 1, 1) and k.dtype == np.float32
    # through the depthwise conv it is the sharpen stencil normalised to sum 1
    x = _rand(1, 8, 12, 3, seed=52)
    _close(nn.depthwise_conv2d(_t(x), _t(k), padding=1, pad_mode="reflect"),
           jnn.depthwise_conv2d(jnp.asarray(x), jnp.asarray(k), padding=1, pad_mode="reflect"))


@pytest.mark.parametrize("method,dst", [("area", (6, 10)), ("bilinear", (20, 36)), ("bicubic", (9, 15)),
                                        ("nearest", (24, 40))])
def test_resize_nchw_matches_jax(method, dst):
    x = np.random.default_rng(53).random((2, 3, 12, 20), dtype=np.float32)
    got = resize_nchw(_t(x), dst, method)
    assert got.shape == (2, 3, *dst)
    _close(got, jresize_nchw(jnp.asarray(x), dst, method))


def test_cast_params_matches_jax():
    tree = {"convs": [{"w": _rand(3, 3, 2, 4, seed=54), "b": _rand(4, seed=55)}],
            "steps": np.arange(3, dtype=np.int32), "tail": ({"alpha": _rand(4, seed=56)},)}
    torch_tree = jax.tree.map(_t, tree)
    got = models.cast_params(torch_tree, torch.bfloat16)
    want = jmodels.cast_params(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    assert got["steps"] is torch_tree["steps"] and got["steps"].dtype == torch.int32
    assert isinstance(got["convs"], list) and isinstance(got["tail"], tuple)
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == 4
    for g, w in zip(got_leaves, want_leaves):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
