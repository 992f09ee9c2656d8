"""The port's training recipes (sharkshark_tpu_torch/train: losses,
schedules, the VSR, SISR and denoise steps, checkpoints) against the JAX
package's train/, on the CPU in float32, with the same weights (the
port's seeded init handed to JAX as numpy) and the same inputs (numpy
from a seed).  The JAX steps run no Pallas kernel: the gather warp and
the XLA shift conv.

Tolerances:
- losses: rtol 1e-6 on sums of a few dozen float32 terms, atol 1e-7;
- schedules at steps 0..N: atol 1e-7 (JAX evaluates them in float32);
- forward_sequence and clip_forward outputs: atol 1e-4 (float32 sums in
  another order through ~20 convs, as tests/test_torch_egvsr.py);
- each recipe's loss: rel 1e-5 (Charbonnier sums of order 1e3-1e4); each
  gradient leaf: ||port - jax|| / ||jax|| <= 1e-4;
- the optimizer against optax on identical gradients: atol 1e-7 on
  parameters of order 0.05 (an update is about lr, and the two round it
  differently by ~1e-7 of it);
- a resumed run against an uninterrupted one: bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import srvgg as jsrvgg
from sharkshark_tpu.ops import backward_warp as jbackward_warp
from sharkshark_tpu.train import denoise as jdenoise
from sharkshark_tpu.train import losses as jlosses
from sharkshark_tpu.train import schedules as jschedules
from sharkshark_tpu.train import sisr as jsisr
from sharkshark_tpu.train import vsr as jvsr
from sharkshark_tpu_torch.models import bsvd, egvsr, srvgg
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.train import checkpoint, denoise, losses, schedules, sisr, vsr

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores: two threads a worker keep them from
    oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

TINY_FR = dict(nf=16, nb=2)
TINY_SR = dict(num_feat=8, num_conv=2)
GRAD_REL = 1e-4
LOSS_REL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach().numpy() if torch.is_tensor(a) else a), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _unflatten(like, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v) for v in tree]
        return next(it)

    return rebuild(like)


def _assert_grads_close(params, grads_port, grads_jax):
    """Leaf by leaf, matched by position in the (key-sorted) pytree."""
    got = jax.tree.leaves(_np(_unflatten(params, grads_port)))
    want = jax.tree.leaves(_np(grads_jax))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(_np(grads_jax))[0]]
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        err = np.linalg.norm(g.astype(np.float64) - w)
        ref = np.linalg.norm(w.astype(np.float64))
        assert err <= GRAD_REL * ref + 1e-12, (path, err, ref)


# ------------------------------------------------------------------ losses


def test_charbonnier_matches_torch_formula():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 4).astype(np.float32)
    y = rng.randn(2, 3, 4).astype(np.float32)
    want = np.sum(np.sqrt((x - y) ** 2 + 1e-6))
    np.testing.assert_allclose(losses.charbonnier_loss(_t(x), _t(y)).numpy(), want, rtol=1e-6)


def test_gan_losses():
    logits = torch.tensor([[0.0, 2.0], [-2.0, 1.0]])
    sig = 1 / (1 + np.exp(-logits.numpy()))
    np.testing.assert_allclose(losses.vanilla_gan_loss(logits, True), -np.mean(np.log(sig)), rtol=1e-5)
    np.testing.assert_allclose(losses.vanilla_gan_loss(logits, False), -np.mean(np.log(1 - sig)), rtol=1e-5)
    np.testing.assert_allclose(losses.lsgan_loss(logits, True), np.mean((logits.numpy() - 1) ** 2), rtol=1e-6)


def test_cosine_similarity_loss_zero_for_identical():
    x = torch.ones((2, 5, 3))
    assert float(losses.cosine_similarity_loss(x, x)) == pytest.approx(0.0, abs=1e-6)


def test_criterion_registry():
    assert losses.define_criterion(None) is None
    crit = losses.define_criterion({"type": "CB", "reduction": "mean"})
    assert float(crit(torch.ones(3), torch.ones(3))) == pytest.approx(1e-3, rel=1e-2)
    with pytest.raises(ValueError):
        losses.define_criterion({"type": "nope"})


@pytest.mark.parametrize("name,kw", [
    ("charbonnier_loss", {}), ("charbonnier_loss", {"reduction": "mean"}),
    ("mse_loss", {}), ("mse_loss", {"reduction": "sum"}), ("cosine_similarity_loss", {}),
])
def test_losses_match_jax(name, kw):
    x, y = _rand(1, 2, 3, 4, 5), _rand(2, 2, 3, 4, 5)
    got = getattr(losses, name)(_t(x), _t(y), **kw).numpy()
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["vanilla_gan_loss", "lsgan_loss"])
@pytest.mark.parametrize("status", [True, False])
def test_gan_losses_match_jax(name, status):
    logits = (_rand(3, 4, 6) - 0.5) * 8
    got = getattr(losses, name)(_t(logits), status).numpy()
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(logits), status))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- schedules


def test_multistep_schedule():
    sched = schedules.multistep_lr(1.0, [10, 20], gamma=0.1)
    assert sched(0) == pytest.approx(1.0)
    assert sched(10) == pytest.approx(0.1)
    assert sched(25) == pytest.approx(0.01, rel=1e-5)


def test_cosine_restart_schedule():
    sched = schedules.cosine_annealing_restart(1.0, periods=[10, 10], restart_weights=[1.0, 0.5])
    assert sched(0) == pytest.approx(1.0)
    assert sched(9) < 0.1
    assert sched(10) == pytest.approx(0.5)
    via_registry = schedules.define_lr_schedule({"type": "CosineAnnealingLR_Restart", "periods": [10, 10]}, 1.0)
    assert via_registry(0) == pytest.approx(1.0)


# the three recipes' configs (configs/*_derived.yml), shortened, and a
# multistep schedule
SCHEDULES = [
    ({"type": "CosineAnnealingLR_Restart", "periods": [16, 60], "restart_weights": [1.0, 0.5],
      "eta_min": 2.0e-5}, 2.0e-4),
    ({"type": "CosineAnnealingLR_Restart", "periods": [12], "restart_weights": [1.0], "eta_min": 2.0e-5}, 2.0e-4),
    ({"type": "CosineAnnealingLR_Restart", "periods": [20], "restart_weights": [1.0], "eta_min": 1.0e-5}, 1.0e-4),
    ({"type": "MultiStepLR", "milestones": [5, 9], "gamma": 0.5}, 5.0e-5),
    ({"type": "FixedLR"}, 5.0e-5),
    (None, 5.0e-5),
]


@pytest.mark.parametrize("sched_opt,base", SCHEDULES)
def test_schedule_matches_jax_at_every_step(sched_opt, base):
    got = schedules.define_lr_schedule(sched_opt, base)
    want = jschedules.define_lr_schedule(sched_opt, base)
    for step in range(90):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=0, atol=1e-7, err_msg=str(step))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_with_schedule_matches_optax(weight_decay):
    """Identical gradients each step: the loss sum(p * g) has gradient g.
    Parameters of order 0.05, as a conv's weights are: at order 1 a
    parameter's own ulp (6e-8) would take up the tolerance."""
    sched_opt, base = SCHEDULES[0]
    tree = {"a": _rand(0, 3, 4) * 0.05, "b": [_rand(1, 5) * 0.05, _rand(2, 2, 2) * 0.05]}
    state = vsr.new_train_state(tree, "cpu", base, 0.9, 0.999, weight_decay)
    sched = schedules.define_lr_schedule(sched_opt, base)
    jsched = jschedules.define_lr_schedule(sched_opt, base)
    tx = (optax.adamw(jsched, b1=0.9, b2=0.999, weight_decay=weight_decay) if weight_decay
          else optax.adam(jsched, b1=0.9, b2=0.999))
    jp = _j(tree)
    jstate = tx.init(jp)
    rng = np.random.default_rng(7)
    for step in range(20):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), _np(tree))
        loss = sum((p * _t(gl)).sum() for p, gl in zip(vsr.param_leaves(state.params), vsr.param_leaves(g)))
        vsr.apply_gradients(state, loss, sched)
        updates, jstate = tx.update(_j(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for a, b in zip(jax.tree.leaves(_np(state.params)), jax.tree.leaves(_np(jp))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=str(step))
    assert state.step == 20


# ----------------------------------------------------------------- forward


def test_forward_sequence_matches_jax():
    cfg, jcfg = egvsr.EGVSRConfig(**TINY_FR), jegvsr.EGVSRConfig(**TINY_FR)
    tp = egvsr.init_params(torch.Generator().manual_seed(0), cfg)
    lr = _rand(3, 2, 3, 16, 24, 3)
    got = egvsr.forward_sequence(tp, _t(lr), cfg=cfg)
    want = jax.jit(lambda p, x: jegvsr.forward_sequence(p, x, cfg=jcfg))(_j(tp), jnp.asarray(lr))
    assert got["hr_data"].shape == (2, 3, 64, 96, 3)
    for k in ("hr_data", "hr_flow", "lr_prev", "lr_curr", "lr_flow"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=k)


def test_training_after_inference_in_one_process():
    """The port caches device constants (resize taps, the conv_out fold's
    indices, blur weights) per device; one first made under
    torch.inference_mode, as the services run, must still be usable by
    autograd in a later training step."""
    cfg = egvsr.EGVSRConfig(**TINY_FR)
    tp = egvsr.init_params(torch.Generator().manual_seed(0), cfg)
    lr = _t(_rand(5, 1, 3, 24, 40, 3))
    with torch.inference_mode():
        egvsr.infer_sequence(tp, lr.transpose(0, 1), cfg=cfg)
    state = vsr.create_train_state(None, vsr.VSRTrainConfig(model_cfg=cfg), params=tp, device="cpu")
    state, logs = vsr.make_train_step(vsr.VSRTrainConfig(model_cfg=cfg))(state, lr, _t(_rand(6, 1, 3, 96, 160, 3)))
    assert state.step == 1 and np.isfinite(float(logs["l_total"]))


def test_denoise_clip_forward_matches_jax():
    """clip_forward (one layer-major chunk over the clip + SHIFT_NUM flush
    frames, library route) equals the JAX package's clip_forward, which
    the JAX package's own tests hold equal to its scan path, denoise_clip
    (matched against the reference's streaming protocol)."""
    tp = bsvd.init_params(torch.Generator().manual_seed(0))
    x = _rand(4, 5, 1, 16, 16, 4)
    got = denoise.clip_forward(tp, _t(x)).numpy()
    assert got.shape == (5, 1, 16, 16, 3)
    want = jax.jit(jdenoise.clip_forward)(_j(tp), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _recorder(fn, calls, name):
    def wrapped(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    return wrapped


def test_chunk_step_routes_shift_convs_as_the_caller_asks(monkeypatch):
    """The serving default takes K1's wrapper for all 16 shift convs;
    training's clip_forward takes the library route for all 16 and K1's
    never; no other value is accepted."""
    calls = []
    plain = tsm.tsm_conv_plain  # what K1's wrapper runs on a CPU tensor
    monkeypatch.setattr(tsm, "tsm_conv", _recorder(plain, calls, "kernel"))
    monkeypatch.setattr(tsm, "tsm_conv_plain", _recorder(plain, calls, "library"))
    tp = bsvd.init_params(torch.Generator().manual_seed(0))
    x = _t(_rand(5, 4, 1, 16, 16, 4))
    y_kernel, _ = bsvd.chunk_step(tp, bsvd.init_chunk_state(1, 16, 16), x)
    assert calls == ["kernel"] * bsvd.SHIFT_NUM
    calls.clear()
    y_lib, _ = bsvd.chunk_step(tp, bsvd.init_chunk_state(1, 16, 16), x, shift_conv="library")
    assert calls == ["library"] * bsvd.SHIFT_NUM
    torch.testing.assert_close(y_lib, y_kernel, rtol=0, atol=0)
    calls.clear()
    denoise.clip_forward(tp, x)
    assert calls == ["library"] * bsvd.SHIFT_NUM
    with pytest.raises(ValueError, match="shift_conv"):
        bsvd.chunk_step(tp, bsvd.init_chunk_state(1, 16, 16), x, shift_conv="cudnn")


# ----------------------------------------------------------------- recipes


def _vsr_pair(**kw):
    cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(**TINY_FR), **kw)
    jcfg = jvsr.VSRTrainConfig(model_cfg=jegvsr.EGVSRConfig(**TINY_FR), **kw)
    return cfg, jcfg, egvsr.init_params(torch.Generator().manual_seed(1), cfg.model_cfg)


def _jax_vsr_loss(jcfg):
    pix = jlosses.define_criterion(jcfg.pixel_crit or {"type": "CB"})
    warp = jlosses.define_criterion(jcfg.warping_crit or {"type": "CB"})

    def loss(params, lr, gt):
        out = jegvsr.forward_sequence(params, lr, cfg=jcfg.model_cfg)
        l_warp = warp(jbackward_warp(out["lr_prev"], out["lr_flow"]), out["lr_curr"])
        return jcfg.pixel_weight * pix(out["hr_data"], gt) + jcfg.warping_weight * l_warp

    return loss


def _sisr_pair():
    cfg = sisr.SISRTrainConfig(model_cfg=srvgg.SRVGGConfig(**TINY_SR))
    jcfg = jsisr.SISRTrainConfig(model_cfg=jsrvgg.SRVGGConfig(**TINY_SR))
    return cfg, jcfg, srvgg.init_params(torch.Generator().manual_seed(2), cfg.model_cfg)


def _jax_sisr_loss(jcfg):
    def loss(params, lr, gt):
        n, t, h, w, c = lr.shape
        out = jsrvgg.apply(params, lr.reshape(n * t, h, w, c), cfg=jcfg.model_cfg)
        return jlosses.charbonnier_loss(out, gt.reshape(n * t, *gt.shape[2:]))

    return loss


def _jax_denoise_loss(jcfg):
    def loss(params, noisy4, gt):
        out = jdenoise.clip_forward(params, noisy4.transpose(1, 0, 2, 3, 4), cfg=jcfg.model_cfg)
        return jlosses.charbonnier_loss(out.transpose(1, 0, 2, 3, 4), gt)

    return loss


def _recipe(name):
    """(port loss_fn, JAX loss, port params, JAX step maker + state maker
    or None, lr input, gt) of one recipe at a tiny size."""
    if name == "vsr":
        cfg, jcfg, tp = _vsr_pair(lr=1e-3)
        lr, gt = _rand(10, 2, 3, 16, 16, 3), _rand(11, 2, 3, 64, 64, 3)
        return vsr.make_loss_fn(cfg), _jax_vsr_loss(jcfg), tp, None, lr, gt
    if name == "sisr":
        cfg, jcfg, tp = _sisr_pair()
        lr, gt = _rand(12, 2, 1, 8, 8, 3), _rand(13, 2, 1, 32, 32, 3)
        return (sisr.make_sisr_loss_fn(cfg), _jax_sisr_loss(jcfg), tp,
                lambda p: (jsisr.make_sisr_train_step(jcfg), jsisr.create_sisr_state(None, jcfg, params=p)), lr, gt)
    cfg, jcfg = denoise.DenoiseTrainConfig(), jdenoise.DenoiseTrainConfig()
    tp = bsvd.init_params(torch.Generator().manual_seed(3))
    gt = _rand(14, 1, 4, 16, 16, 3)
    sigma = np.float32(25 / 255)
    noisy = gt + sigma * np.random.default_rng(15).standard_normal(gt.shape).astype(np.float32)
    noisy4 = np.concatenate([noisy, np.full(gt.shape[:-1] + (1,), sigma, np.float32)], -1)
    return denoise.make_denoise_loss_fn(cfg), _jax_denoise_loss(jcfg), tp, None, noisy4, gt


@pytest.mark.parametrize("name", ["vsr", "sisr", "denoise"])
def test_recipe_loss_and_gradients_match_jax(name):
    loss_fn, jloss, tp, jstep, x, gt = _recipe(name)
    state = vsr.new_train_state(tp, "cpu", 1e-3, 0.9, 0.999)
    loss, logs = loss_fn(state.params, _t(x), _t(gt))
    grads = torch.autograd.grad(loss, vsr.param_leaves(state.params))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(_j(tp), jnp.asarray(x), jnp.asarray(gt))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_REL)
    assert float(logs["l_total"]) == float(loss)
    _assert_grads_close(tp, grads, jg)
    if jstep is not None:
        # the test's JAX loss is the JAX step's own (its logs read the loss
        # before the update)
        step, jstate = jstep(_j(tp))
        _, jlogs = jax.jit(step)(jstate, jnp.asarray(x), jnp.asarray(gt))
        np.testing.assert_allclose(float(jlogs["l_total"]), float(jl), rtol=1e-6)


def test_train_step_reduces_loss():
    cfg, _, _ = _vsr_pair(lr=1e-3)
    state = vsr.create_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = vsr.make_train_step(cfg)
    lr, gt = _t(_rand(1, 2, 3, 8, 8, 3)), _t(_rand(2, 2, 3, 32, 32, 3))
    state, logs0 = step(state, lr, gt)
    for _ in range(10):
        state, logs = step(state, lr, gt)
    assert float(logs["l_total"]) < float(logs0["l_total"])
    assert state.step == 11
    assert "l_pix_G" in logs and "l_warp_G" in logs


def test_sisr_train_step_reduces_loss():
    cfg = sisr.SISRTrainConfig(model_cfg=srvgg.SRVGGConfig(num_feat=16, num_conv=2), lr=1e-3)
    state = sisr.create_sisr_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = sisr.make_sisr_train_step(cfg)
    lr, gt = _t(_rand(1, 2, 1, 8, 8, 3)), _t(_rand(2, 2, 1, 32, 32, 3))
    state, logs0 = step(state, lr, gt)
    for _ in range(20):
        state, logs = step(state, lr, gt)
    assert float(logs["l_total"]) < float(logs0["l_total"])
    assert state.step == 21


def test_denoise_train_step_reduces_loss():
    cfg = denoise.DenoiseTrainConfig(lr=1e-3)
    state = denoise.create_denoise_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = denoise.make_denoise_train_step(cfg)
    gt = _t(_rand(1, 2, 4, 16, 16, 3))
    state, logs0 = step(state, None, gt)
    for _ in range(10):
        state, logs = step(state, None, gt)
    assert float(logs["l_total"]) < float(logs0["l_total"])
    assert state.step == 11
    assert 10.0 / 255.0 <= float(logs["sigma_mean"]) <= 50.0 / 255.0


def test_denoise_noise_stream_is_restart_stable():
    """A resumed run replays the same noise: the step seeds its generator
    from (noise_seed, state.step), not from a global RNG."""
    cfg = denoise.DenoiseTrainConfig(lr=1e-3)
    step = denoise.make_denoise_train_step(cfg)
    gt = _t(_rand(1, 1, 3, 16, 16, 3))
    s = denoise.create_denoise_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    s, _ = step(s, None, gt)
    s2 = denoise.create_denoise_state(None, cfg, params=s.params, device="cpu")
    s2.step = s.step
    torch.manual_seed(123)  # the global RNG plays no part
    _, logs_a = step(s, None, gt)
    _, logs_b = step(s2, None, gt)
    assert float(logs_a["sigma_mean"]) == float(logs_b["sigma_mean"])
    assert float(logs_a["l_pix_G"]) == float(logs_b["l_pix_G"])
    a0, _ = denoise.noisy_input(cfg, gt, 0)
    a1, _ = denoise.noisy_input(cfg, gt, 1)
    assert not torch.equal(a0, a1)


def _tiny_run(name):
    """(state maker, step, lr batches, gt batches) of one recipe."""
    if name == "vsr":
        cfg, _, _ = _vsr_pair(lr=1e-3)
        return (lambda seed: vsr.create_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu"),
                vsr.make_train_step(cfg, schedules.cosine_annealing_restart(1e-3, [3, 5], [1.0, 0.5], 1e-4)),
                [_t(_rand(20 + i, 2, 3, 8, 8, 3)) for i in range(4)],
                [_t(_rand(30 + i, 2, 3, 32, 32, 3)) for i in range(4)])
    if name == "sisr":
        cfg, _, _ = _sisr_pair()
        return (lambda seed: sisr.create_sisr_state(torch.Generator().manual_seed(seed), cfg, device="cpu"),
                sisr.make_sisr_train_step(cfg, schedules.multistep_lr(2e-4, [2])),
                [_t(_rand(40 + i, 2, 1, 8, 8, 3)) for i in range(4)],
                [_t(_rand(50 + i, 2, 1, 32, 32, 3)) for i in range(4)])
    cfg = denoise.DenoiseTrainConfig()
    return (lambda seed: denoise.create_denoise_state(torch.Generator().manual_seed(seed), cfg, device="cpu"),
            denoise.make_denoise_train_step(cfg, schedules.cosine_annealing_restart(1e-4, [4], eta_min=1e-5)),
            [None] * 4, [_t(_rand(60 + i, 1, 3, 16, 16, 3)) for i in range(4)])


@pytest.mark.parametrize("name", ["vsr", "sisr", "denoise"])
def test_resumed_run_is_bit_identical(tmp_path, name):
    """Two steps, a checkpoint, a fresh state (other seed) restored from
    it, two more steps == four steps without the break: parameters,
    Adam's moments and counts, and the step, bit for bit."""
    make, step, lrs, gts = _tiny_run(name)
    straight = make(0)
    for lr, gt in zip(lrs, gts):
        straight, _ = step(straight, lr, gt)

    first = make(0)
    for lr, gt in zip(lrs[:2], gts[:2]):
        first, _ = step(first, lr, gt)
    path = checkpoint.save_checkpoint(str(tmp_path), first, first.step)
    assert os.path.basename(path) == "ckpt_000000002"
    resumed = checkpoint.load_checkpoint(checkpoint.latest_checkpoint(str(tmp_path)), make(1))
    assert resumed.step == 2
    for lr, gt in zip(lrs[2:], gts[2:]):
        resumed, _ = step(resumed, lr, gt)

    assert resumed.step == straight.step == 4
    for a, b in zip(vsr.param_leaves(resumed.params), vsr.param_leaves(straight.params)):
        assert torch.equal(a, b)
    sa, sb = resumed.opt.state_dict(), straight.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k in sb["state"]:
        for key, v in sb["state"][k].items():
            assert torch.equal(sa["state"][k][key], v), (k, key)


def test_export_torch_bsvd_round_trip():
    """The JAX tool that exports minted BSVD params to the reference's
    state dict layout, read back by the port's from_torch, gives the
    params of the port's from_jax, exactly."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from export_torch_bsvd import params_to_state_dict

    params = _np(bsvd.init_params(torch.Generator().manual_seed(3)))
    sd = {k: v.numpy() for k, v in params_to_state_dict(params).items()}
    got = jax.tree.leaves(_np(bsvd.from_torch(sd)))
    want = jax.tree.leaves(_np(bsvd.from_jax(params)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_default_device_is_the_card():
    """The recipes run on CUDA unless the caller asks for the CPU: here,
    without CUDA, the default raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default would train on it")
    cfg, _, _ = _vsr_pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vsr.create_train_state(torch.Generator().manual_seed(0), cfg)
