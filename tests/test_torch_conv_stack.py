"""The port's fused conv + PReLU stack (K4, sharkshark_tpu_torch/ops/
conv_stack.py) on the CPU, where the wrapper runs its plain version:
against the JAX package's Pallas kernel (experiments/conv_stack.py) in
interpret mode, and SRVGG's `conv_stack` route against the JAX SRVGG.

Tolerances: the Pallas kernel at 0.02 x max(|ref|max, 1) in bf16, as
experiments/tests/test_pallas_conv.py holds it (each layer rounds to bf16
once, from f32 sums in another order); SRVGG in float32 at atol 1e-4
(sums of 9*64 products in another order).  The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_conv_stack_cuda.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import experiments.conv_stack as jcs
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu_torch.models import srvgg
from sharkshark_tpu_torch.ops import _build
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.tools import bench_conv_stack, bench_tsm_conv
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService

# 64 features (what K4 takes), 4 body layers: groups of 3 + 1 at conv_stack=3
SRVGG_J = jsrvgg.SRVGGConfig(num_feat=64, num_conv=4)
SRVGG = srvgg.SRVGGConfig(num_feat=64, num_conv=4)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("shape", [(1, 90, 160), (2, 90, 240)])
def test_plain_matches_pallas_interpret(interpret_mode, n_layers, shape):
    n, h, w = shape
    rng = np.random.default_rng(n_layers * 10 + n)
    x = rng.standard_normal((n, h, w, 64)).astype(np.float32)
    wt = (rng.standard_normal((n_layers, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    a = np.linspace(0.1, 0.4, n_layers * 64, dtype=np.float32).reshape(n_layers, 64)
    want = jcs.fused_conv_stack.__wrapped__(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16), jnp.asarray(a), tile=(45, 80))
    want = np.asarray(want).astype(np.float32)
    got = cs.fused_conv_stack(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(wt).to(torch.bfloat16), torch.from_numpy(a))
    assert got.shape == (n, h, w, 64) and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.02 * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("n_layers", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_stack_is_its_layers_chained(n_layers, dtype):
    """The function K4's L chained launches compute: the plain version at
    L layers equals L one-layer plain calls, each on the last one's
    output, bit for bit (each layer rounds to x's dtype once)."""
    rng = np.random.default_rng(n_layers)
    x = torch.from_numpy(rng.standard_normal((2, 11, 13, 64)).astype(np.float32)).to(dtype)
    wt = torch.from_numpy((rng.standard_normal((n_layers, 3, 3, 64, 64)) * 0.05).astype(np.float32)).to(dtype)
    a = torch.from_numpy(rng.uniform(0.05, 0.4, (n_layers, 64)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((n_layers, 64)) * 0.1).astype(np.float32))
    y = x
    for l in range(n_layers):
        y = cs.fused_conv_stack_plain(y, wt[l : l + 1], a[l : l + 1], b[l : l + 1])
    assert torch.equal(cs.fused_conv_stack(x, wt, a, b), y)


def _params(seed):
    """Seeded port weights with random biases and alphas, and the same
    as numpy for the JAX package (its pytree layout is the same)."""
    rng = np.random.default_rng(seed)
    tp = srvgg.init_params(torch.Generator().manual_seed(seed), SRVGG)
    for conv in tp["convs"]:
        conv["b"] = torch.from_numpy((rng.standard_normal(conv["b"].shape) * 0.1).astype(np.float32))
    for act in tp["acts"]:
        act["alpha"] = torch.from_numpy(rng.uniform(0.05, 0.4, act["alpha"].shape).astype(np.float32))
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp), tp


@pytest.mark.parametrize("conv_stack", [1, 3])
def test_srvgg_conv_stack_route_matches_jax(conv_stack):
    jp, tp = _params(conv_stack)
    x = np.random.default_rng(9).random((2, 12, 20, 3)).astype(np.float32)
    before = cs.launches
    got = srvgg.apply(tp, torch.from_numpy(x), cfg=SRVGG, conv_stack=conv_stack)
    assert got.shape == (2, 48, 80, 3) and cs.launches == before
    want = jsrvgg.apply(jp, jnp.asarray(x), cfg=SRVGG_J)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got = srvgg.apply_down_rational(tp, torch.from_numpy(x), 2, 1, cfg=SRVGG, conv_stack=conv_stack)
    want = jsrvgg.apply_down_rational(jp, jnp.asarray(x), 2, 1, cfg=SRVGG_J)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_srvgg_body_groups_its_layers(monkeypatch):
    """conv_stack=3 over 4 body layers: one stack of 3 and one of 1."""
    depths = []
    orig = cs.fused_conv_stack

    def spy(x, weights, alphas, bias=None):
        depths.append(weights.shape[0])
        return orig(x, weights, alphas, bias)

    monkeypatch.setattr(cs, "fused_conv_stack", spy)
    _, tp = _params(0)
    srvgg.apply(tp, torch.rand((1, 8, 8, 3)), cfg=SRVGG, conv_stack=3)
    assert depths == [3, 1]


@pytest.mark.parametrize("kw,match", [
    (dict(conv_stack=2, srvgg_cfg=srvgg.SRVGGConfig(num_feat=16, num_conv=2)), "num_feat"),
    (dict(conv_stack=2, srvgg_cfg=srvgg.SRVGGConfig(act_type="relu")), "prelu"),
    (dict(conv_stack=cs.L_MAX + 1), "conv_stack must be"),
])
def test_service_refuses_a_config_k4_cannot_take(kw, match):
    with pytest.raises(ValueError, match=match):
        EsrganUpscalerService(device="cpu", **kw)


def test_default_depth_follows_the_config():
    """Unset, conv_stack is K4's default depth where K4 takes the config
    and 0 (layer by layer) where it does not; it never raises."""
    assert srvgg.resolve_conv_stack(srvgg.GENERAL_X4V3, None) == srvgg.DEFAULT_CONV_STACK >= 1
    assert srvgg.resolve_conv_stack(srvgg.SRVGGConfig(num_feat=16, num_conv=2), None) == 0
    assert EsrganUpscalerService(device="cpu").conv_stack == srvgg.DEFAULT_CONV_STACK
    assert EsrganUpscalerService(device="cpu", conv_stack=0).conv_stack == 0


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = cs.launches
    y = cs.fused_conv_stack(torch.rand((1, 9, 7, 64)).to(torch.bfloat16),
                            torch.rand((2, 3, 3, 64, 64)) * 0.05, torch.full((2, 64), 0.2))
    assert y.shape == (1, 9, 7, 64) and y.dtype == torch.bfloat16 and cs.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((1, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        cs.fused_conv_stack(x, torch.empty((1, 3, 3, 64, 64), device="meta"),
                            torch.empty((1, 64), device="meta"))


def test_bench_bound_at_the_body_shape():
    """tools/bench_conv_stack.py's bound at SRVGG's body shape, (4, 720,
    1280, 64) bf16: one layer moves x and out (0.94 GB, 0.2817 ms at 3.35
    TB/s) in more time than its 2.72e11 FLOP take at 989 TFLOP/s; two
    layers are operations-bound."""
    flops, nbytes = bench_conv_stack.work()
    assert flops == 2 * 9 * 64 * 64 * 4 * 720 * 1280
    assert nbytes == 2 * (4 * 720 * 1280 * 64 * 2) + 9 * 64 * 64 * 2 + 2 * 64 * 4
    one = bench_tsm_conv.bound(flops, nbytes)
    assert one["bound_by"] == "bytes" and round(one["bound_ms"], 4) == 0.2817
    two = bench_tsm_conv.bound(*bench_conv_stack.work(n_layers=2))
    assert two["bound_by"] == "operations" and round(two["bound_ms"], 4) == 0.5496
