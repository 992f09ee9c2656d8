"""The port's EGVSR (sharkshark_tpu_torch/models/egvsr.py) against the JAX
package's, on the CPU in float32, with the same weights: the port's
seeded init handed to JAX as numpy, or both packages loading the repo's
minted checkpoint.  The JAX functions run as the JAX package's own tests
run them on the CPU (the gather warp; no Pallas kernel there).

Tolerances: FNet, SRNet and one recurrence step agree to atol 1e-4 on
values of order 1 (float32 sums in another order through ~20 convs; the
warp's sample points move by ~1e-5 px, see tests/test_torch_warp.py).
Over several steps of the recurrence, atol 1e-3.  Weight loading and the
conv_out fold agree exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import torch_import as jti
from sharkshark_tpu_torch.models import egvsr, torch_import
from sharkshark_tpu_torch.ops import space_to_depth

MINTED = Path(__file__).resolve().parent.parent / "weights" / "minted" / "egvsr-derived-x4.pth"
TINY = dict(nf=16, nb=2)
ATOL = 1e-4
ATOL_RECURRENT = 1e-3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.numpy() if torch.is_tensor(a) else a), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=ATOL):
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol)


def _params(seed=0, **cfg):
    tcfg, jcfg = egvsr.EGVSRConfig(**cfg), jegvsr.EGVSRConfig(**cfg)
    tp = egvsr.init_params(torch.Generator().manual_seed(seed), tcfg)
    return tp, jax.tree.map(jnp.asarray, _np(tp)), tcfg, jcfg


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).random((n, 1, h, w, 3), dtype=np.float32)


def test_init_params_has_the_jax_layout():
    tp, _, tcfg, jcfg = _params(**TINY)
    want = jegvsr.init_params(jax.random.PRNGKey(0), jcfg)
    assert jax.tree.structure(_np(tp)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(_np(tp)), jax.tree.leaves(want)):
        assert a.shape == b.shape


@pytest.mark.parametrize("h,w", [(16, 24), (20, 28), (27, 19)])
def test_fnet_matches_jax(h, w):
    """H or W not divisible by 8: FNet's output is H//8*8, which the step
    reflect-pads back."""
    tp, jp, _, _ = _params(**TINY)
    f = _frames(2, h, w, seed=h)
    got = egvsr.fnet_apply(tp["fnet"], _t(f[0]), _t(f[1]))
    want = jegvsr.fnet_apply(jp["fnet"], jnp.asarray(f[0]), jnp.asarray(f[1]))
    assert got.shape == want.shape == (1, h // 8 * 8, w // 8 * 8, 2)
    _close(got, want)


def test_fold_conv_out_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    tw, tb, tpad = egvsr._fold_conv_out(_t(w), _t(b), 4)
    jw, jb, jpad = jegvsr._fold_conv_out(jnp.asarray(w), jnp.asarray(b), 4)
    assert tpad == jpad == 1 and tuple(tw.shape) == jw.shape == (3, 3, 64, 48)
    _close(tw, jw, atol=0)
    _close(tb, jb, atol=0)


def test_srnet_matches_jax():
    tp, jp, _, _ = _params(**TINY)
    rng = np.random.default_rng(2)
    lr = rng.random((2, 12, 20, 3), dtype=np.float32)
    tran = rng.random((2, 12, 20, 48), dtype=np.float32)
    got = egvsr.srnet_apply(tp["srnet"], _t(lr), _t(tran))
    want = jegvsr.srnet_apply(jp["srnet"], jnp.asarray(lr), jnp.asarray(tran))
    assert got.shape == want.shape == (2, 48, 80, 3)
    _close(got, want)


@pytest.mark.parametrize("degradation", ["BI", "BD"])
@pytest.mark.parametrize("cut", [None, 0.12])
def test_frnet_step_matches_jax(degradation, cut):
    """One step, smooth motion (no cut) and a scene cut (the skip), BI
    and BD (the TecoGAN bicubic flow upsample); the K3 wrapper on a CPU
    tensor is the plain warp."""
    tp, jp, tcfg, jcfg = _params(degradation=degradation, **TINY)
    f = _frames(2, 20, 24, seed=3)
    hr_prev = np.random.default_rng(4).random((1, 80, 96, 3), dtype=np.float32)
    lr_prev = f[0]
    for lr_curr in (np.clip(lr_prev + 0.01, 0, 1), 1.0 - lr_prev):  # smooth, then a cut
        got = egvsr.frnet_step(tp, _t(lr_curr), _t(lr_prev), _t(hr_prev), cfg=tcfg, cut_threshold=cut)
        want = jegvsr.frnet_step(jp, jnp.asarray(lr_curr), jnp.asarray(lr_prev), jnp.asarray(hr_prev),
                                 cfg=jcfg, cut_threshold=cut)
        _close(got, want)


def test_cut_skips_the_warp():
    """At a cut hr_prev goes to SRNet unwarped (JAX test_cut_skip_warp
    _fallback); a first frame against the zero state is a cut."""
    tp, _, tcfg, _ = _params(**TINY)
    f = _frames(1, 16, 16, seed=5)[0]
    hr_prev = _t(np.random.default_rng(6).random((1, 64, 64, 3), dtype=np.float32))
    got = egvsr.frnet_step(tp, _t(1.0 - f), _t(f), hr_prev, cfg=tcfg, cut_threshold=0.12)
    want = egvsr.srnet_apply(tp["srnet"], _t(1.0 - f), space_to_depth(hr_prev, 4))
    assert torch.equal(got, want)
    lr0, hr0 = egvsr.init_recurrent_state(1, 16, 16, tcfg)
    first, _ = egvsr.infer_step(tp, (lr0, hr0), _t(f), cfg=tcfg, cut_threshold=0.12)
    assert torch.equal(first, egvsr.srnet_apply(tp["srnet"], _t(f), torch.zeros((1, 16, 16, 48))))


@pytest.mark.parametrize("cut", [None, 0.12])
def test_infer_chunk_matches_steps_and_jax(cut):
    """infer_chunk (FNet batched over T) against T x infer_step, with a
    scene cut mid-chunk, and against JAX infer_chunk; the carried state
    too."""
    tp, jp, tcfg, jcfg = _params(seed=4, **TINY)
    frames = _frames(4, 16, 16, seed=7)
    frames[2] = 1.0 - frames[1]  # scene cut at index 2
    state = egvsr.init_recurrent_state(1, 16, 16, tcfg)
    outs = []
    for f in frames:
        y, state = egvsr.infer_step(tp, state, _t(f), cfg=tcfg, cut_threshold=cut)
        outs.append(y)
    chunk, state_c = egvsr.infer_chunk(tp, egvsr.init_recurrent_state(1, 16, 16, tcfg), _t(frames),
                                       cfg=tcfg, cut_threshold=cut)
    _close(chunk, torch.stack(outs), atol=ATOL_RECURRENT)
    _close(state_c[0], state[0], atol=0)
    _close(state_c[1], state[1], atol=ATOL_RECURRENT)
    jchunk, jstate = jegvsr.infer_chunk(jp, jegvsr.init_recurrent_state(1, 16, 16, jcfg),
                                        jnp.asarray(frames), cfg=jcfg, fast_warp=False, cut_threshold=cut)
    _close(chunk, jchunk, atol=ATOL_RECURRENT)
    _close(state_c[1], jstate[1], atol=ATOL_RECURRENT)


def test_infer_sequence_matches_jax():
    tp, jp, tcfg, jcfg = _params(seed=5, **TINY)
    frames = _frames(3, 16, 24, seed=8)
    got = egvsr.infer_sequence(tp, _t(frames), cfg=tcfg)
    want = jegvsr.infer_sequence(jp, jnp.asarray(frames), cfg=jcfg)
    assert got.shape == want.shape == (3, 1, 64, 96, 3)
    _close(got, want, atol=ATOL_RECURRENT)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "dual-reflect"])
def test_pad_sequence_matches_jax(mode):
    x = _frames(5, 4, 6, seed=9)
    got, n = egvsr.pad_sequence(_t(x), 2, mode)
    want, jn = jegvsr.pad_sequence(jnp.asarray(x), 2, mode)
    assert n == jn == 2
    _close(got, want, atol=0)
    with pytest.raises(ValueError, match="padding mode"):
        egvsr.pad_sequence(_t(x), 1, "wrap")


@pytest.fixture(scope="module")
def minted():
    return jti.load_state_dict(str(MINTED))


def test_config_from_torch_on_the_minted_file(minted):
    cfg = egvsr.config_from_torch(minted)
    assert (cfg.nb, cfg.nf, cfg.degradation) == (10, 64, "BI")
    assert tuple(cfg) == tuple(jegvsr.config_from_torch(minted))


def test_from_torch_and_from_jax_give_the_same_params(minted):
    cfg = egvsr.config_from_torch(minted)
    via_jax = egvsr.from_jax(_np(jegvsr.from_torch(minted, jegvsr.config_from_torch(minted))))
    direct = egvsr.from_torch(torch_import.load_state_dict(str(MINTED)), cfg)
    assert jax.tree.structure(_np(direct)) == jax.tree.structure(_np(via_jax))
    for a, b in zip(jax.tree.leaves(_np(direct)), jax.tree.leaves(_np(via_jax))):
        np.testing.assert_array_equal(a, b)


def test_minted_step_matches_jax(minted):
    """Two recurrent steps of the minted nb=10 net at a small size."""
    cfg, jcfg = egvsr.config_from_torch(minted), jegvsr.config_from_torch(minted)
    tp = egvsr.from_torch(minted, cfg)
    jp = jegvsr.from_torch(minted, jcfg)
    frames = _frames(2, 16, 24, seed=10)
    ts, js = egvsr.init_recurrent_state(1, 16, 24, cfg), jegvsr.init_recurrent_state(1, 16, 24, jcfg)
    for f in frames:
        got, ts = egvsr.infer_step(tp, ts, _t(f), cfg=cfg, cut_threshold=0.12)
        want, js = jegvsr.infer_step(jp, js, jnp.asarray(f), cfg=jcfg, cut_threshold=0.12)
        _close(got, want, atol=ATOL_RECURRENT)
