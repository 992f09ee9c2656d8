"""The port's temporal-shift conv (sharkshark_tpu_torch/ops/tsm_conv.py)
on the CPU, where the wrapper runs its plain version, against the JAX
package's Pallas kernel in interpret mode and against its XLA
formulation bsvd._shift_conv_chunk.

Tolerances: bf16 inputs compare at rtol = atol = 0.05 on float32 values,
as tests/test_tsm_conv.py does for the Pallas kernel (one bf16 rounding
of outputs of order 1, plus a different rounding point of the bias);
float32 compares at atol 1e-4 (sums of 9*C products in another order).
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.ops.pallas.tsm_conv import tsm_conv as jtsm_conv
from sharkshark_tpu_torch.models import bsvd
from sharkshark_tpu_torch.ops import _build
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService


def _mk(t, h, w, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, 1, h, w, c)).astype(np.float32)
    center = rng.standard_normal((1, h, w, c)).astype(np.float32)
    left = rng.standard_normal((1, h, w, c // 8)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    return x, center, left, wt, b


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("t,c,act", [
    (1, 64, "relu6"), (2, 64, "relu6"), (4, 64, "relu6"),
    (1, 128, "relu6"), (2, 128, "relu6"), (4, 128, "relu6"),
    (4, 64, "relu"), (2, 128, "relu"), (2, 64, "none"), (3, 128, "none"),
])
def test_plain_matches_pallas_interpret_bf16(t, c, act):
    x, center, left, wt, b = _mk(t, 16, 8, c, seed=t * 1000 + c)
    want = jtsm_conv(
        jnp.asarray(x[:, 0], jnp.bfloat16), jnp.asarray(center[0], jnp.bfloat16),
        jnp.asarray(left[0], jnp.bfloat16), wt, b, act=act, interpret=True,
    )
    got = tsm.tsm_conv(_bf16(x[:, 0]), _bf16(center[0]), _bf16(left[0]),
                       _bf16(wt), _bf16(b), act)
    assert got.dtype == torch.bfloat16 and got.shape == (t, 16, 8, c)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("t,c,act", [(1, 64, "relu6"), (2, 128, "relu"), (4, 64, "relu6"),
                                     (4, 24, "relu6"), (3, 24, "relu")])
def test_shift_conv_and_carry_match_xla_f32(t, c, act):
    """The port's bsvd shift conv (wrapper + carry) against the JAX
    formulation in float32, including the general C=24 of the tiny test
    config (plain version only: the kernel takes C in {64, 128})."""
    x, center, left, wt, b = _mk(t, 8, 12, c, seed=7 + t + c)
    want, want_st = jbsvd._shift_conv_chunk(
        {"w": jnp.asarray(wt), "b": jnp.asarray(b)},
        {"left": jnp.asarray(left), "center": jnp.asarray(center)}, jnp.asarray(x), act)
    got, got_st = bsvd._shift_conv_chunk(
        {"w": torch.from_numpy(wt), "b": torch.from_numpy(b)},
        {"left": torch.from_numpy(left), "center": torch.from_numpy(center)},
        torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for k in ("left", "center"):
        np.testing.assert_array_equal(got_st[k].numpy(), np.asarray(want_st[k]))


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = tsm.launches
    x, center, left, wt, b = _mk(2, 8, 8, 64, seed=3)
    y = tsm.tsm_conv(_bf16(x), _bf16(center), _bf16(left), _bf16(wt), _bf16(b))
    assert y.shape == x.shape and tsm.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((2, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        tsm.tsm_conv(x, x[0], x[0, ..., :8], x[0, :3, :3, :64], x[0, 0, 0])


def test_service_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EsrganUpscalerService()
