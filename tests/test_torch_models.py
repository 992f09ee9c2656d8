"""The port's models (sharkshark_tpu_torch/models) against the JAX
package's, on the CPU in float32, with the same weights: the JAX
parameter pytrees handed over as numpy, or both packages loading the
repo's minted .pth files.

Tolerance: atol 1e-4 on values of order 1 (SRVGG: 34 convs; BSVD: two
U-Nets over several chunks), from float32 sums taken in another order;
weight loading must agree exactly."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import bsvd as jbsvd
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.models import torch_import as jti
from sharkshark_tpu_torch.models import bsvd, srvgg, torch_import

MINTED = Path(__file__).resolve().parent.parent / "weights" / "minted"
SRVGG_PTH = MINTED / "srvgg-derived-x4.pth"
BSVD_PTH = MINTED / "bsvd-derived-32.pth"

TINY_SRVGG_J = jsrvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY_SRVGG = srvgg.SRVGGConfig(num_feat=16, num_conv=2)
TINY_BSVD_J = jbsvd.BSVDConfig(chns=(8, 16, 24))
TINY_BSVD = bsvd.BSVDConfig(chns=(8, 16, 24))
ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, atol=ATOL, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, atol, f"{path}[{i}]")
    else:
        g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol, err_msg=path)


@pytest.fixture(scope="module")
def minted_srvgg():
    sd = jti.load_state_dict(str(SRVGG_PTH))
    return sd, jsrvgg.from_torch(sd)


@pytest.fixture(scope="module")
def minted_bsvd():
    sd = jti.load_state_dict(str(BSVD_PTH))
    return sd, jbsvd.from_torch(sd)


def test_srvgg_tiny_apply_and_fused_epilogue():
    jp = jax.jit(jsrvgg.init_params, static_argnums=1)(jax.random.PRNGKey(0), TINY_SRVGG_J)
    tp = srvgg.from_jax(_np(jp))
    x = np.random.default_rng(0).random((2, 12, 20, 3)).astype(np.float32)
    got = srvgg.apply(tp, torch.from_numpy(x), cfg=TINY_SRVGG)
    assert got.shape == (2, 48, 80, 3)
    _assert_tree_close(got, jsrvgg.apply(jp, jnp.asarray(x), cfg=TINY_SRVGG_J))
    got = srvgg.apply_down_rational(tp, torch.from_numpy(x), 2, 1, cfg=TINY_SRVGG)
    _assert_tree_close(got, jsrvgg.apply_down_rational(jp, jnp.asarray(x), 2, 1, cfg=TINY_SRVGG_J))


def test_srvgg_minted_general_x4v3(minted_srvgg):
    sd, jp = minted_srvgg
    tp = srvgg.from_torch(torch_import.load_state_dict(str(SRVGG_PTH)))
    x = np.random.default_rng(1).random((1, 24, 40, 3)).astype(np.float32)
    _assert_tree_close(srvgg.apply(tp, torch.from_numpy(x)), jsrvgg.apply(jp, jnp.asarray(x)))
    _assert_tree_close(srvgg.apply_down_rational(tp, torch.from_numpy(x), 2, 1),
                       jsrvgg.apply_down_rational(jp, jnp.asarray(x), 2, 1))


def test_from_torch_matches_from_jax_on_minted_files(minted_srvgg, minted_bsvd):
    for (sd, jp), mod, cfg in ((minted_srvgg, srvgg, srvgg.GENERAL_X4V3),
                               (minted_bsvd, bsvd, bsvd.BSVD_32)):
        via_torch = mod.from_torch(torch_import.load_state_dict(str(SRVGG_PTH if mod is srvgg else BSVD_PTH)), cfg)
        _assert_tree_close(via_torch, _np(jp), atol=0, path=mod.__name__)
        _assert_tree_close(mod.from_jax(_np(jp)), _np(jp), atol=0, path=mod.__name__)


def _run_stream(jp, cfg_j, cfg, h, w, seed):
    """cold chunks -> warm chunks -> ring_to_fifo_state -> t_end flush,
    in both packages from the same frames; compares every output and the
    whole state after each step."""
    T = 4
    n_live = 24  # 4 cold chunks (t < 16), then 2 warm ones
    rng = np.random.default_rng(seed)
    frames = rng.random((n_live, 1, h, w, cfg.in_ch)).astype(np.float32)
    tp = bsvd.from_jax(_np(jp))
    j_chunk = jax.jit(jbsvd.chunk_step, static_argnames=("cfg", "warm"))
    js = jbsvd.init_stream_state(1, h, w, cfg_j)
    ts = bsvd.init_stream_state(1, h, w, cfg)
    for i in range(0, n_live, T):
        warm = i >= bsvd.SHIFT_NUM
        jy, js = j_chunk(jp, js, jnp.asarray(frames[i : i + T]), cfg=cfg_j, warm=warm)
        ty, ts = bsvd.chunk_step(tp, ts, torch.from_numpy(frames[i : i + T]), cfg=cfg, warm=warm)
        _assert_tree_close(ty, jy, path=f"y@{i}")
        _assert_tree_close(bsvd.state_to_numpy(ts), _np(js), path=f"state@{i}")
    js = jbsvd.ring_to_fifo_state(js, cfg_j)
    ts = bsvd.ring_to_fifo_state(ts, cfg)
    _assert_tree_close(bsvd.state_to_numpy(ts), _np(js), path="fifo")
    zeros = np.zeros((T, 1, h, w, cfg.in_ch), np.float32)
    for i in range(bsvd.SHIFT_NUM // T):
        jy, js = j_chunk(jp, js, jnp.asarray(zeros), cfg=cfg_j, t_end=n_live)
        ty, ts = bsvd.chunk_step(tp, ts, torch.from_numpy(zeros), cfg=cfg, t_end=n_live)
        _assert_tree_close(ty, jy, path=f"flush y@{i}")
    _assert_tree_close(bsvd.state_to_numpy(ts), _np(js), path="flushed")
    # a JAX state carried over continues identically
    ts2 = bsvd.state_from_jax(_np(js))
    assert ts2["t"] == ts["t"] == n_live + bsvd.SHIFT_NUM


def test_bsvd_chunk_step_tiny_stream():
    jp = jax.jit(jbsvd.init_params, static_argnums=1)(jax.random.PRNGKey(2), TINY_BSVD_J)
    _run_stream(jp, TINY_BSVD_J, TINY_BSVD, 16, 24, seed=3)


def test_bsvd_chunk_step_minted_stream(minted_bsvd):
    _, jp = minted_bsvd
    _run_stream(jp, jbsvd.BSVD_32, bsvd.BSVD_32, 16, 24, seed=4)


def _rings(state):
    return [state[b][k] for b in ("temp1", "temp2") for k in ("skip1", "skip2")]


def test_bsvd_inplace_rings_match_the_copying_route():
    """The service's warm step writes its new frames into the skip rings
    in place (chunk_step(inplace=True)): over cold -> warm x 3 ->
    ring_to_fifo_state -> flush it gives the copying route's outputs and
    whole state bit for bit, keeps each skip1/skip2 ring's storage, and
    the copying route leaves the state passed in as it was."""
    tp = bsvd.init_params(torch.Generator().manual_seed(5), TINY_BSVD)
    h, w, T = 16, 24, 4
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(
        rng.random((bsvd.SHIFT_NUM + 3 * T, 1, h, w, TINY_BSVD.in_ch)).astype(np.float32))
    states = {inplace: bsvd.init_stream_state(1, h, w, TINY_BSVD) for inplace in (False, True)}

    def same(path):
        _assert_tree_close(bsvd.state_to_numpy(states[True]), bsvd.state_to_numpy(states[False]),
                           atol=0, path=path)

    for i in range(0, frames.shape[0], T):
        warm = i >= bsvd.SHIFT_NUM
        old, before = states[False], bsvd.state_to_numpy(states[False])
        ptrs = [r.data_ptr() for r in _rings(states[True])]
        y_copy, states[False] = bsvd.chunk_step(tp, old, frames[i : i + T], cfg=TINY_BSVD, warm=warm)
        y_inplace, new = bsvd.chunk_step(tp, states[True], frames[i : i + T], cfg=TINY_BSVD,
                                         warm=warm, inplace=True)
        if warm:
            assert [r.data_ptr() for r in _rings(new)] == ptrs, f"a ring moved @{i}"
            assert all(a is b for a, b in zip(_rings(new), _rings(states[True])))
        states[True] = new
        assert torch.equal(y_inplace, y_copy), f"y@{i}"
        same(f"state@{i}")
        # the copying route's input state is untouched (a caller may reuse it)
        _assert_tree_close(bsvd.state_to_numpy(old), before, atol=0, path=f"input state@{i}")
    states = {k: bsvd.ring_to_fifo_state(s, TINY_BSVD) for k, s in states.items()}
    same("fifo")
    zeros = torch.zeros((T, 1, h, w, TINY_BSVD.in_ch))
    for i in range(bsvd.SHIFT_NUM // T):
        ys = {}
        for k in states:
            ys[k], states[k] = bsvd.chunk_step(tp, states[k], zeros, cfg=TINY_BSVD, t_end=frames.shape[0],
                                               inplace=k)
        assert torch.equal(ys[True], ys[False]), f"flush y@{i}"
    same("flushed")
