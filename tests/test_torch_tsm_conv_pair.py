"""The port's fused shift-conv pair (K2, sharkshark_tpu_torch/ops/
tsm_conv.py::tsm_conv_pair) on the CPU, where the wrapper runs its plain
version: against the JAX package's Pallas kernel in interpret mode, and
the `tsm_pair` route of bsvd.chunk_step against the K1 route and against
the JAX chunk_step.

Tolerances: bf16 at rtol = atol = 0.06, as tests/test_tsm_conv.py holds
the Pallas pair against two sequential convs (y1 rounds to bf16 at
another point on each side and feeds the second conv); float32 at atol
1e-4 (sums of 9*C products in another order).  On the CPU the JAX
chunk_step takes its XLA route: its pair route needs a TPU backend.  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_tsm_conv_pair_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.ops.pallas.tsm_conv import tsm_conv_pair as jtsm_conv_pair
from sharkshark_tpu_torch.models import bsvd
from sharkshark_tpu_torch.ops import _build
from sharkshark_tpu_torch.ops import tsm_conv as tsm

# the mem blocks' shift convs at K1's widths, where chunk_step takes the
# kernel route (any other width takes the shift-and-concatenate conv,
# which has no pair)
PAIR_BSVD_J = jbsvd.BSVDConfig(chns=(8, *tsm.KERNEL_CHANNELS))
PAIR_BSVD = bsvd.BSVDConfig(chns=(8, *tsm.KERNEL_CHANNELS))


def _mk(t, h, w, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, h, w, c)).astype(np.float32)
    carries = [rng.standard_normal(s).astype(np.float32)
               for s in ((h, w, c), (h, w, c // 8), (h, w, c), (h, w, c // 8))]
    w1, w2 = ((rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.standard_normal((c,)) * 0.1).astype(np.float32) for _ in range(2))
    return x, carries, w1, b1, w2, b2


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _check_against_pallas(t, h, w, c, act):
    x, carries, w1, b1, w2, b2 = _mk(t, h, w, c, seed=t * 10 + c)
    want_y2, want_carry = jtsm_conv_pair(
        jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(a, jnp.bfloat16) for a in carries),
        w1, b1, w2, b2, act=act, interpret=True)
    got_y2, got_carry = tsm.tsm_conv_pair(_bf16(x), *(_bf16(a) for a in carries),
                                          _bf16(w1), _bf16(b1), _bf16(w2), _bf16(b2), act)
    assert got_y2.shape == (t, h, w, c) and got_carry.shape == (2, h, w, c)
    assert got_y2.dtype == got_carry.dtype == torch.bfloat16
    np.testing.assert_allclose(got_y2.float().numpy(), np.asarray(want_y2).astype(np.float32),
                               rtol=0.06, atol=0.06)
    np.testing.assert_allclose(got_carry.float().numpy(), np.asarray(want_carry).astype(np.float32),
                               rtol=0.06, atol=0.06)


@pytest.mark.parametrize("t,h,w,c", [(4, 16, 8, 64), (2, 24, 16, 128), (3, 16, 8, 64)])
def test_plain_matches_pallas_interpret_bf16(t, h, w, c):
    _check_against_pallas(t, h, w, c, "relu6")


@pytest.mark.parametrize("t,h,w,c,act", [(3, 16, 8, 64, "none"), (2, 24, 16, 128, "relu")])
def test_plain_matches_pallas_interpret_bf16_other_act(t, h, w, c, act):
    _check_against_pallas(t, h, w, c, act)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=1e-4, err_msg=path)


def _counting(monkeypatch, calls, name, attr):
    """Count the calls of tsm.<attr> under calls[name]."""
    fn = getattr(tsm, attr)

    def wrapped(*a, **k):
        calls[name] += 1
        return fn(*a, **k)

    monkeypatch.setattr(tsm, attr, wrapped)


def test_chunk_step_pair_route_matches_k1_route_and_jax(monkeypatch):
    """cold -> warm -> ring_to_fifo_state -> flush, float32, the same
    frames through chunk_step(tsm_pair=True), chunk_step(tsm_pair=False)
    and the JAX chunk_step; outputs and whole states after every step.
    The pair route must call the pair wrapper on every warm chunk."""
    calls = {"pair": 0}
    _counting(monkeypatch, calls, "pair", "tsm_conv_pair")
    h, w, t = 16, 24, 4
    jp = jax.jit(jbsvd.init_params, static_argnums=1)(jax.random.PRNGKey(5), PAIR_BSVD_J)
    tp = bsvd.from_jax(_np(jp))
    frames = np.random.default_rng(6).random((24, 1, h, w, PAIR_BSVD.in_ch)).astype(np.float32)
    j_chunk = jax.jit(jbsvd.chunk_step, static_argnames=("cfg", "warm"))
    js = jbsvd.init_stream_state(1, h, w, PAIR_BSVD_J)
    pair = k1 = bsvd.init_stream_state(1, h, w, PAIR_BSVD)
    for i in range(0, 24, t):
        warm = i >= bsvd.SHIFT_NUM
        x = frames[i : i + t]
        jy, js = j_chunk(jp, js, jnp.asarray(x), cfg=PAIR_BSVD_J, warm=warm)
        before = calls["pair"]
        py, pair = bsvd.chunk_step(tp, pair, torch.from_numpy(x), cfg=PAIR_BSVD, warm=warm, tsm_pair=True)
        assert calls["pair"] - before == (8 if warm else 0), (i, calls)
        ky, k1 = bsvd.chunk_step(tp, k1, torch.from_numpy(x), cfg=PAIR_BSVD, warm=warm)
        assert calls["pair"] - before == (8 if warm else 0), "the K1 route called the pair wrapper"
        _close(py, jy, f"y@{i}")
        _close(py, ky.numpy(), f"y vs K1 route@{i}")
        _close(bsvd.state_to_numpy(pair), _np(js), f"state@{i}")
        _close(bsvd.state_to_numpy(pair), bsvd.state_to_numpy(k1), f"state vs K1 route@{i}")
    assert calls["pair"] == 8 * (24 - bsvd.SHIFT_NUM) // t
    js = jbsvd.ring_to_fifo_state(js, PAIR_BSVD_J)
    pair = bsvd.ring_to_fifo_state(pair, PAIR_BSVD)
    zeros = np.zeros((t, 1, h, w, PAIR_BSVD.in_ch), np.float32)
    for i in range(bsvd.SHIFT_NUM // t):
        jy, js = j_chunk(jp, js, jnp.asarray(zeros), cfg=PAIR_BSVD_J, t_end=24)
        py, pair = bsvd.chunk_step(tp, pair, torch.from_numpy(zeros), cfg=PAIR_BSVD, t_end=24,
                                   tsm_pair=True)
        _close(py, jy, f"flush y@{i}")
    _close(bsvd.state_to_numpy(pair), _np(js), "flushed")


def test_pair_route_launches_k2_only_on_warm_chunks(monkeypatch):
    """A warm T=4 chunk calls the pair wrapper 8 times and K1's none; a
    cold chunk and a warm T=1 chunk keep K1 (16 calls per chunk).  The
    shift convs run at K1's widths (chunk_step routes any other width to
    the shift-and-concatenate conv, which has no pair)."""
    calls = {"pair": 0, "single": 0}
    _counting(monkeypatch, calls, "pair", "tsm_conv_pair")
    _counting(monkeypatch, calls, "single", "tsm_conv")
    tp = bsvd.init_params(torch.Generator().manual_seed(0), PAIR_BSVD)
    st = bsvd.init_stream_state(1, 8, 8, PAIR_BSVD)
    x = torch.rand((4, 1, 8, 8, 4))
    for warm, frames, want in ((False, x, (0, 16)), (True, x, (8, 0)), (True, x[:1], (0, 16))):
        calls.update(pair=0, single=0)
        bsvd.chunk_step(tp, st, frames, cfg=PAIR_BSVD, warm=warm, tsm_pair=True)
        assert (calls["pair"], calls["single"]) == want, (warm, frames.shape, calls)


def test_cpu_tensor_never_touches_the_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path must not build or load a kernel")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    before = tsm.pair_launches
    x, carries, w1, b1, w2, b2 = _mk(2, 8, 8, 64, seed=3)
    y2, carry = tsm.tsm_conv_pair(_bf16(x), *(_bf16(a) for a in carries),
                                  _bf16(w1), _bf16(b1), _bf16(w2), _bf16(b2))
    assert y2.shape == x.shape and carry.shape == (2, *x.shape[1:]) and tsm.pair_launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((2, 8, 8, 64), device="meta", dtype=torch.bfloat16)
    w = torch.empty((3, 3, 64, 64), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        tsm.tsm_conv_pair(x, x[0], x[0, ..., :8], x[0], x[0, ..., :8], w, None, w, None)
