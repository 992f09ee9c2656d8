"""The port's sharded VSR train step (sharkshark_tpu_torch/parallel/
sharded.py::make_sharded_train_step) on the CPU: against the JAX
package's make_sharded_train_step on the conftest's 8 virtual CPU
devices, and against the port's own single-device train step, on a mesh
that repeats the CPU (its counterpart of virtual devices), with the same
numpy inputs and weights.

Tolerances (as tests/test_torch_train.py holds a recipe): the loss at
rel 1e-5; each gradient leaf at ||port - ref|| / ||ref|| <= 1e-4.  After
one whole step against JAX: Adam's first moment leaf by leaf at rel
1e-4 and its second at 2e-4 (they are the gradient and its square), and
the parameters at atol 1e-7 against optax's update of the port's own
gradients (test_torch_train.py's optimizer tolerance).  The updates are
not compared with JAX's directly: Adam's first update is about the rate
times the sign of g, so the few elements whose gradient lies near zero
move by visibly different amounts when the gradients agree at 1e-4.  One
width the halo covers whole (every band computes the whole clip) and
one where the bands cut (256 LR columns over 2 and 4 bands)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sharkshark_tpu import parallel as jpar
from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.train import vsr as jvsr
from sharkshark_tpu_torch import parallel as par
from sharkshark_tpu_torch.models import egvsr
from sharkshark_tpu_torch.parallel import _bands
from sharkshark_tpu_torch.train import losses, vsr, vsrgan

CPU = torch.device("cpu")
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach().numpy() if torch.is_tensor(a) else a), tree)


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _mesh(n, spatial):
    return par.make_mesh(devices=[CPU] * n, spatial=spatial)


def _cfg(nb=1, **kw):
    cfg = vsr.VSRTrainConfig(model_cfg=egvsr.EGVSRConfig(nf=16, nb=nb), lr=1e-3, **kw)
    return cfg, egvsr.init_params(torch.Generator().manual_seed(1), cfg.model_cfg)


def _step(fn, cfg, params, lr, gt):
    """One step of fn from a fresh state over `params`: (logs, gradients,
    state)."""
    state = vsr.new_train_state(params, "cpu", cfg.lr, cfg.beta1, cfg.beta2)
    state, logs = fn(state, torch.from_numpy(lr), torch.from_numpy(gt))
    return {k: float(v) for k, v in logs.items()}, [p.grad.clone() for p in vsr.param_leaves(state.params)], state


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("w,n,spatial,crit", [
    (16, 8, 2, {}),
    (256, 2, 2, {}),
    (256, 4, 4, {}),
    (256, 2, 2, {"pixel_crit": {"type": "MSE"}, "warping_crit": {"type": "CB", "reduction": "mean"}}),
], ids=["halo_covers_w16_d4xs2", "bands_cut_w256_s2", "bands_cut_w256_s4", "mean_criteria_w256_s2"])
def test_sharded_train_step_matches_the_single_device_step(w, n, spatial, crit):
    cfg, params = _cfg(**crit)
    data = n // spatial
    lr, gt = _rand(1, 2 * data, 3, 8, w, 3), _rand(2, 2 * data, 3, 32, 4 * w, 3)
    step = vsr.make_train_step(cfg)
    logs, grads, _ = _step(step, cfg, params, lr, gt)
    slogs, sgrads, state = _step(par.make_sharded_train_step(step, _mesh(n, spatial)), cfg, params, lr, gt)
    assert state.step == 1
    assert set(slogs) == set(logs) == {"l_pix_G", "l_warp_G", "l_total"}
    for k in logs:
        assert abs(slogs[k] - logs[k]) <= LOSS_REL * abs(logs[k]), (k, slogs[k], logs[k])
    errs = [_rel(a, b) for a, b in zip(sgrads, grads)]
    assert max(errs) <= GRAD_REL, max(errs)
    bands = _bands.split_width(w, [CPU] * spatial, 8, par.egvsr_radius(cfg.model_cfg))
    computed = sum(b.hi - b.lo for b in bands)
    if w == 16:
        assert all((b.lo, b.hi) == (0, w) for b in bands)  # every band the whole clip
    else:
        assert all(b.hi - b.lo < w for b in bands) and len(bands) == spatial, bands
        assert computed < spatial * w


def test_a_short_halo_shows():
    """The comparison above sees the halo: with 16 columns where the step
    reads 72, the bands' gradient strays far beyond the tolerance."""
    cfg, params = _cfg()
    lr, gt = _rand(1, 2, 3, 8, 256, 3), _rand(2, 2, 3, 32, 1024, 3)
    step = vsr.make_train_step(cfg)
    _, grads, _ = _step(step, cfg, params, lr, gt)
    sharded = par.make_sharded_train_step(step, _mesh(2, 2))
    orig = par.sharded.egvsr_radius
    try:
        par.sharded.egvsr_radius = lambda c: 16
        short = par.make_sharded_train_step(step, _mesh(2, 2))
    finally:
        par.sharded.egvsr_radius = orig
    _, sgrads, _ = _step(short, cfg, params, lr, gt)
    assert max(_rel(a, b) for a, b in zip(sgrads, grads)) > 100 * GRAD_REL
    _, sgrads, _ = _step(sharded, cfg, params, lr, gt)
    assert max(_rel(a, b) for a, b in zip(sgrads, grads)) <= GRAD_REL


def _leaf_rel(got, want):
    return [float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want))]


@pytest.mark.parametrize("w", [16, 32, 256], ids=["w16_as_the_jax_test", "w32", "w256_bands_cut"])
def test_sharded_train_step_matches_jax(w):
    """tests/test_parallel.py's case (nf 16, nb 1, make_mesh(8,
    spatial=2), clips (4, 3, 8, 16, 3) and (4, 3, 32, 64, 3)), and the
    same mesh at wider clips (at 256 the port's bands cut): the JAX step
    on 8 virtual devices and the port's on the CPU 8 times, from the same
    weights: the logs, Adam's moments and the parameters.

    At the JAX test's own width (8 LR columns a shard, one column after
    FNet's third pooling) the JAX sharded step's gradients of FNet's
    encoder and first decoder conv are 4x its own unsharded step's
    (XLA's partitioning; at 32 columns and wider they agree within 1e-5).
    There the moments are held against the JAX unsharded step, which
    the JAX sharded step is meant to equal; the logs against the sharded
    one.  That 4x is held too, so that the substitution goes on being
    needed: if JAX's sharded step comes to agree, this test says so."""
    cfg, params = _cfg()
    jcfg = jvsr.VSRTrainConfig(model_cfg=jegvsr.EGVSRConfig(nf=16, nb=1), lr=1e-3)
    lr, gt = _rand(3, 4, 3, 8, w, 3), _rand(4, 4, 3, 32, 4 * w, 3)
    jmesh = jpar.make_mesh(8, spatial=2)
    jstate = jvsr.create_train_state(None, jcfg, params=jax.tree.map(jnp.asarray, _np(params)))
    with jmesh:
        jsharded, jlogs = jpar.make_sharded_train_step(jvsr.make_train_step(jcfg), jmesh)(
            jstate, jnp.asarray(lr), jnp.asarray(gt))
    jref = jsharded if w >= 32 else jax.jit(jvsr.make_train_step(jcfg))(jstate, jnp.asarray(lr), jnp.asarray(gt))[0]
    if w < 32:
        # the JAX sharded step's first moment is 4x the unsharded one's on
        # FNet's encoder and first decoder conv, and equal elsewhere
        flat = jax.tree_util.tree_flatten_with_path(jsharded.opt_state[0].mu)[0]
        four = [jax.tree_util.keystr(k).startswith(("['fnet']['enc", "['fnet']['dec1'][0]")) for k, _ in flat]
        want = [4 * np.asarray(b) if f else np.asarray(b) for f, b in zip(four, jax.tree.leaves(jref.opt_state[0].mu))]
        assert sum(four) == 14
        assert max(_leaf_rel([v for _, v in flat], want)) <= GRAD_REL
    logs, _, state = _step(par.make_sharded_train_step(vsr.make_train_step(cfg), _mesh(8, 2)), cfg, params, lr, gt)
    assert state.step == int(jsharded.step) == 1
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k], float(jlogs[k]), rtol=LOSS_REL, err_msg=k)
    leaves = vsr.param_leaves(state.params)
    adam = jref.opt_state[0]
    # mu is (1 - b1) g and nu (1 - b2) g^2: nu's relative error is twice g's
    for key, jtree, tol in (("exp_avg", adam.mu, GRAD_REL), ("exp_avg_sq", adam.nu, 2 * GRAD_REL)):
        got = _bands.tree_map(lambda p: state.opt.state[p][key].numpy(), _rebuild(params, leaves))
        errs = _leaf_rel(got, jtree)
        assert max(errs) <= tol, (key, max(errs))
    # the parameters after the step: optax's Adam update of the port's own
    # gradients, at test_torch_train.py's optimizer tolerance
    grads = _bands.tree_map(lambda p: p.grad.numpy(), _rebuild(params, leaves))
    tx = optax.adam(cfg.lr, b1=cfg.beta1, b2=cfg.beta2)
    start = jax.tree.map(jnp.asarray, _np(params))
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(start), start)
    want = optax.apply_updates(start, updates)
    for a, b in zip(jax.tree.leaves(_np(state.params)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)


def _rebuild(like, leaves):
    it = iter(leaves)
    return _bands.tree_map(lambda _: next(it), like)


def test_a_batch_the_data_axis_does_not_split_is_refused():
    cfg, params = _cfg()
    step = par.make_sharded_train_step(vsr.make_train_step(cfg), _mesh(8, 2))
    with pytest.raises(ValueError, match="does not divide by the mesh's data axis"):
        _step(step, cfg, params, _rand(1, 2, 3, 8, 16, 3), _rand(2, 2, 3, 32, 64, 3))


def test_a_step_that_exposes_no_loss_is_refused():
    """The GAN step exposes neither its loss function nor a schedule; a
    bare closure neither; a loss function without its config is named."""
    gan_step = vsrgan.make_gan_train_step(vsrgan.VSRGANConfig())
    for fn in (gan_step, lambda state, lr, gt: (state, {})):
        with pytest.raises(TypeError, match="no loss_fn and no schedule"):
            par.make_sharded_train_step(fn, _mesh(2, 2))

    def bare(state, lr, gt):
        return state, {}

    bare.loss_fn, bare.schedule = (lambda p, lr, gt: None), (lambda s: 1e-3)
    with pytest.raises(TypeError, match="loss_fn.cfg"):
        par.make_sharded_train_step(bare, _mesh(2, 2))


def test_a_criterion_that_does_not_split_is_refused():
    cfg, _ = _cfg(pixel_crit={"type": "CosineSimilarity"})
    with pytest.raises(ValueError, match="does not split"):
        par.make_sharded_train_step(vsr.make_train_step(cfg), _mesh(2, 2))


def test_the_single_device_step_exposes_its_loss_and_schedule():
    cfg, params = _cfg()
    sched = lambda s: 1e-3 / (1 + s)  # noqa: E731
    step = vsr.make_train_step(cfg, sched)
    assert step.schedule is sched and step.loss_fn.cfg is cfg
    lr, gt = _rand(1, 2, 3, 8, 16, 3), _rand(2, 2, 3, 32, 64, 3)
    loss, logs = step.loss_fn(vsr.new_train_state(params, "cpu", cfg.lr, 0.9, 0.999).params,
                              torch.from_numpy(lr), torch.from_numpy(gt))
    slogs, _, _ = _step(step, cfg, params, lr, gt)
    assert slogs["l_total"] == float(loss.detach())


@pytest.mark.parametrize("opt", [
    {"type": "CB"}, {"type": "MSE"}, {"type": "CB", "reduction": "mean"}, {"type": "MSE", "reduction": "sum"},
    {"type": "CB", "eps": 1e-3, "weight": 2.0},
], ids=["cb", "mse", "cb_mean", "mse_sum", "cb_eps"])
def test_criterion_parts_add_up_to_the_criterion(opt):
    """The parts of two halves of the input, summed and divided by the
    whole count where the criterion is a mean, give define_criterion's
    value: each criterion's default reduction is the one its function
    has."""
    x, y = (torch.from_numpy(_rand(s, 2, 5, 6, 3)).double() for s in (1, 2))
    part, mean = losses.criterion_parts(opt)
    total = part(x[..., :2, :], y[..., :2, :]) + part(x[..., 2:, :], y[..., 2:, :])
    want = losses.define_criterion(opt)(x, y)
    torch.testing.assert_close(total / x.numel() if mean else total, want, rtol=1e-12, atol=0)


def test_the_serving_layer_does_not_load_the_training_tree():
    code = ("import sys, sharkshark_tpu_torch.parallel, sharkshark_tpu_torch.upscale.service\n"
            "print(sorted(m for m in sys.modules if m.startswith('sharkshark_tpu_torch.train')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout
