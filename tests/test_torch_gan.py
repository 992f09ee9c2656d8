"""The port's GAN recipe (sharkshark_tpu_torch/train: discriminators, vgg,
vsrgan, and the driver's GAN branch) against the JAX package's, on the
CPU in float32, with the same weights (the port's seeded init handed to
JAX as numpy) and the same inputs (numpy from a seed), at a tiny size:
FRNet nf 16 / nb 1, a D of spatial size 32, LR 8x8, T 3-4.

The JAX step keeps its D and G losses inside one closure; the reference
losses below rebuild them from the JAX package's own parts
(discriminators, egvsr.forward_sequence, define_criterion), line for line
as sharkshark_tpu/train/vsrgan.py:123-247 composes them, and the whole
step is held against the JAX step itself.

Tolerances:
- D logits and features: atol 1e-4 (float32 convs summed in another
  order, then batch-normalised);
- VGG features: ||port - jax|| / ||jax|| <= 1e-5 per map;
- losses: rel 1e-5; each gradient leaf ||port - jax|| / ||jax|| <= 1e-4
  (as tests/test_torch_train.py), a None gradient (the block convs'
  unused biases) read as zeros.  In one case (the spatio-temporal D with
  feature matching at T 4) the JAX package's own float32 gradient lies
  ~1e-3 from its float64 one on SRNet's first convs, where the port's
  lies within 1e-6: there every leaf is held within 1e-4 of the JAX
  package's gradient in float64 instead;
- a whole step: Adam's moments leaf by leaf at 1e-4 (1e-3 after two
  steps), each leaf's update ||d_port - d_jax|| <= 1e-2 ||d_jax|| (see
  _assert_updates_close), cnt_upd_d and the update counts equal;
- a resumed driver run against an uninterrupted one: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.ops import backward_warp as jbackward_warp
from sharkshark_tpu.ops import resize as jresize
from sharkshark_tpu.train import discriminators as JD
from sharkshark_tpu.train import losses as jlosses
from sharkshark_tpu.train import vgg as jvgg
from sharkshark_tpu.train import vsrgan as jvsrgan
from sharkshark_tpu_torch.models import egvsr
from sharkshark_tpu_torch.train import checkpoint, driver, vgg, vsr, vsrgan
from sharkshark_tpu_torch.train import discriminators as D


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Tiny shapes gain nothing from many CPU threads, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


TINY_G = egvsr.EGVSRConfig(nf=16, nb=1)
JTINY_G = jegvsr.EGVSRConfig(nf=16, nb=1)
SIZE = 32  # the D's spatial size = the GT crop
GRAD_REL = 1e-4
LOSS_REL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach().numpy() if torch.is_tensor(a) else a), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, _np(tree))


def _unflatten(like, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v) for v in tree]
        return next(it)

    return rebuild(like)


def _leaf_errors(params, grads_port, grads_jax):
    """[(path, ||port - jax|| / ||jax||)] leaf by leaf, matched by path; a
    None gradient counts as zeros."""
    leaves = vsr.param_leaves(params)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads_port)]
    got = jax.tree_util.tree_flatten_with_path(_np(_unflatten(params, grads)))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, grads_jax))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    out = []
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        w = w.astype(np.float64)
        out.append((jax.tree_util.keystr(path), np.linalg.norm(g.astype(np.float64) - w) / max(np.linalg.norm(w),
                                                                                               1e-30)))
    return out


def _assert_grads_close(params, grads_port, grads_jax, grads_jax64=None):
    """Every leaf within GRAD_REL of the JAX package's float32 gradient;
    where one is not, every leaf within GRAD_REL of the JAX package's own
    gradient in float64 (`grads_jax64()`, evaluated only then)."""
    errs = _leaf_errors(params, grads_port, grads_jax)
    if max(e for _, e in errs) <= GRAD_REL:
        return
    assert grads_jax64 is not None, max(errs, key=lambda e: e[1])
    errs64 = _leaf_errors(params, grads_port, grads_jax64())
    assert max(e for _, e in errs64) <= GRAD_REL, (max(errs, key=lambda e: e[1]), max(errs64, key=lambda e: e[1]))


def _seeded_vgg19(seed=0):
    """A full torchvision vgg19 `features` state dict with seeded He
    weights and small biases (numpy, OIHW)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for entry in vgg.VGG19_LAYERS:
        if entry == "M":
            continue
        i, cout = entry
        sd[f"features.{i}.weight"] = (rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (cin * 9))).astype(
            np.float32)
        sd[f"features.{i}.bias"] = (rng.standard_normal(cout) * 0.01).astype(np.float32)
        cin = cout
    return sd


@pytest.fixture(scope="module")
def vgg19_sd():
    return _seeded_vgg19()


# ------------------------------------------------------------ discriminators


def _disc_cfgs(use_cond=False):
    kw = dict(in_nc=3, spatial_size=SIZE, tempo_range=3, scale=4, use_cond=use_cond)
    return D.DiscriminatorConfig(**kw), JD.DiscriminatorConfig(**kw)


def _assert_d_out_close(got, want):
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert len(got[1]) == len(want[1]) == 4
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_cond", [False, True])
def test_spatial_d_matches_jax(use_cond):
    cfg, jcfg = _disc_cfgs(use_cond)
    tp = D.init_spatial(torch.Generator().manual_seed(0), cfg)
    data, bi = _rand(1, 2, 3, SIZE, SIZE, 3), _rand(2, 2, 3, SIZE, SIZE, 3)
    got = D.spatial_forward_sequence(tp, _t(data), _t(bi), cfg)
    want = JD.spatial_forward_sequence(_j(tp), jnp.asarray(data), jnp.asarray(bi), jcfg)
    assert got[0].shape == (6, 1)
    _assert_d_out_close(got, want)


def _st_inputs(seed, n=2, t=7):
    lr = _rand(seed, n, t, SIZE // 4, SIZE // 4, 3)
    return (lr, _rand(seed + 1, n, t, SIZE, SIZE, 3), _rand(seed + 2, n, t, SIZE, SIZE, 3),
            (np.random.default_rng(seed + 3).standard_normal((n, t - 1, SIZE, SIZE, 2)) * 2).astype(np.float32))


@pytest.mark.parametrize("use_pp_crit", [True, False])
def test_spatio_temporal_d_matches_jax(use_pp_crit):
    """The merged flow computed (from the ping-pong flows, or by FNet on
    the LR pairs), then reused on another sequence, as the fake pass
    reuses the real pass's."""
    cfg, jcfg = _disc_cfgs()
    tp = D.init_spatio_temporal(torch.Generator().manual_seed(0), cfg)
    gp = egvsr.init_params(torch.Generator().manual_seed(1), TINY_G)
    lr, data, bi, flow = _st_inputs(3)
    kw = dict(use_pp_crit=use_pp_crit, crop_border_ratio=0.75)
    got = D.spatio_temporal_forward_sequence(tp, _t(data), lr_data=_t(lr), bi_data=_t(bi), hr_flow=_t(flow),
                                             fnet_params=gp["fnet"], cfg=cfg, **kw)
    want = JD.spatio_temporal_forward_sequence(_j(tp), jnp.asarray(data), lr_data=jnp.asarray(lr),
                                               bi_data=jnp.asarray(bi), hr_flow=jnp.asarray(flow),
                                               fnet_params=_j(gp)["fnet"], cfg=jcfg, **kw)
    assert got[0].shape == (4, 1) and got[2].shape == (12, SIZE, SIZE, 2)
    _assert_d_out_close(got, want)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-4)
    assert not got[2].requires_grad

    other = _rand(9, 2, 7, SIZE, SIZE, 3)
    got2 = D.spatio_temporal_forward_sequence(tp, _t(other), lr_data=None, bi_data=_t(bi), hr_flow=None,
                                              hr_flow_merge=got[2], cfg=cfg, **kw)
    want2 = JD.spatio_temporal_forward_sequence(_j(tp), jnp.asarray(other), lr_data=None,
                                                bi_data=jnp.asarray(bi), hr_flow=None, hr_flow_merge=want[2],
                                                cfg=jcfg, **kw)
    _assert_d_out_close(got2, want2)


def test_triplet_pack_channel_order():
    """rrrgggbbb: channel c * 3 + k of a clip holds channel c of its
    frame k."""
    x = torch.arange(2 * 3 * 2 * 2 * 3, dtype=torch.float32).reshape(1, 6, 2, 2, 3)
    packed = D._triplet_pack(x, 2, 2, 2, 3)
    for clip in range(2):
        for c in range(3):
            for k in range(3):
                assert torch.equal(packed[clip, ..., c * 3 + k], x[0, clip * 3 + k, ..., c])


def test_batch_norm_is_batch_statistics():
    x = _t(_rand(4, 3, 5, 6, 8) * 4 - 1)
    p = {"scale": _t(_rand(5, 8) + 0.5), "bias": _t(_rand(6, 8))}
    want = torch.nn.functional.batch_norm(x.permute(0, 3, 1, 2), None, None, p["scale"], p["bias"], training=True,
                                          eps=1e-5).permute(0, 2, 3, 1)
    torch.testing.assert_close(D._batch_norm(x, p), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------- VGG


def test_vgg_features_match_jax(vgg19_sd):
    x = _rand(7, 2, SIZE, SIZE, 3)
    got = vgg.VGGFeatureExtractor(vgg19_sd, device="cpu")(_t(x))
    want = jvgg.VGGFeatureExtractor(vgg19_sd)(jnp.asarray(x))
    assert [tuple(f.shape) for f in got] == [(2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512), (2, 2, 2, 512)]
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.numpy() - b) <= 1e-5 * np.linalg.norm(b)


def test_vgg_reads_a_state_dict_file(tmp_path, vgg19_sd):
    path = tmp_path / "vgg19.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg19_sd.items()}, path)
    x = _t(_rand(8, 1, 16, 16, 3))
    got = vgg.VGGFeatureExtractor(str(path), feature_layers=(2, 3), device="cpu")(x)
    want = vgg.VGGFeatureExtractor(vgg19_sd, feature_layers=(2, 3), device="cpu")(x)
    assert len(got) == 2 and torch.equal(got[1], torch.relu(got[0]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ the losses and step


def _gan_cfgs(**kw):
    disc_type = kw.pop("disc_type", "spatio_temporal")
    use_cond = kw.pop("use_cond", False)
    cfg, jcfg = _disc_cfgs(use_cond)
    return (vsrgan.VSRGANConfig(model_cfg=TINY_G, disc_cfg=cfg, disc_type=disc_type, **kw),
            jvsrgan.VSRGANConfig(model_cfg=JTINY_G, disc_cfg=jcfg, disc_type=disc_type, **kw))


def _jax_losses(jcfg, fx=None):
    """(prepare, d_loss, g_loss) of the JAX step, rebuilt from its parts
    as sharkshark_tpu/train/vsrgan.py:123-247 composes them."""
    pix_crit = jlosses.define_criterion({"type": "CB"})
    warp_crit = jlosses.define_criterion({"type": "CB"})
    pp_crit = jlosses.define_criterion({"type": "CB"}) if jcfg.use_pingpong else None
    fm_crit = jlosses.define_criterion({"type": "CB", "reduction": "mean"}) if jcfg.use_feature_matching else None
    feat_crit = jlosses.define_criterion({"type": "CB", "reduction": "mean"}) if fx else None
    gan_crit = jlosses.define_criterion({"type": jcfg.gan_crit})
    mcfg, dcfg = jcfg.model_cfg, jcfg.disc_cfg

    def d_forward(params_d, data, ctx, hr_flow_merge=None):
        if jcfg.disc_type == "spatial":
            logits, feats = JD.spatial_forward_sequence(params_d, data, ctx["bi_data"], dcfg)
            return logits, feats, None
        return JD.spatio_temporal_forward_sequence(
            params_d, data, lr_data=ctx["lr_data"], bi_data=ctx["bi_data"], hr_flow=ctx["hr_flow"],
            fnet_params=ctx["params_g"]["fnet"], use_pp_crit=jcfg.use_pingpong,
            crop_border_ratio=jcfg.crop_border_ratio, hr_flow_merge=hr_flow_merge, cfg=dcfg)

    def prepare(params_g, lr_data, gt_data):
        n, t, lh, lw, c = lr_data.shape
        gh, gw = gt_data.shape[2], gt_data.shape[3]
        bi_data = jresize(lr_data.reshape(n * t, lh, lw, c), (gh, gw), "bicubic").reshape(n, t, gh, gw, c)
        if jcfg.use_pingpong:
            lr_data = jnp.concatenate([lr_data, jnp.flip(lr_data, 1)[:, 1:]], axis=1)
            gt_data = jnp.concatenate([gt_data, jnp.flip(gt_data, 1)[:, 1:]], axis=1)
            bi_data = jnp.concatenate([bi_data, jnp.flip(bi_data, 1)[:, 1:]], axis=1)
        g_out = jegvsr.forward_sequence(params_g, lr_data, cfg=mcfg)
        return {"lr_data": lr_data, "gt_data": gt_data, "bi_data": bi_data, "hr_data": g_out["hr_data"],
                "hr_flow": g_out["hr_flow"], "params_g": params_g}

    def d_loss(params_d, ctx):
        real_logits, real_feats, flow_merge = d_forward(params_d, ctx["gt_data"], ctx)
        fake_logits, _, _ = d_forward(params_d, jax.lax.stop_gradient(ctx["hr_data"]), ctx, flow_merge)
        loss = gan_crit(real_logits, True) + gan_crit(fake_logits, False)
        return loss, (real_logits, fake_logits, real_feats, flow_merge)

    def g_loss(params_g, params_d, ctx, real_feats, flow_merge):
        gt_data = ctx["gt_data"]
        t = (gt_data.shape[1] + 1) // 2  # the clip's length before the ping-pong
        gh, gw, c = gt_data.shape[2:]
        out = jegvsr.forward_sequence(params_g, ctx["lr_data"], cfg=mcfg)
        hr = out["hr_data"]
        loss = jcfg.pixel_weight * pix_crit(hr, gt_data)
        loss += jcfg.warping_weight * warp_crit(jbackward_warp(out["lr_prev"], out["lr_flow"]), out["lr_curr"])
        if feat_crit is not None:
            l_feat = 0.0
            for hf, gf in zip(fx(hr.reshape(-1, gh, gw, c)), fx(gt_data.reshape(-1, gh, gw, c))):
                l_feat += feat_crit(hf, jax.lax.stop_gradient(gf))
            loss += jcfg.feature_weight * l_feat
        if pp_crit is not None:
            loss += jcfg.pingpong_weight * pp_crit(hr[:, : t - 1], jnp.flip(hr[:, t:], 1))
        fake_logits_g, fake_feats_g, _ = d_forward(params_d, hr, dict(ctx, params_g=params_g), flow_merge)
        if fm_crit is not None:
            l_fm = 0.0
            for i, (ff, rf) in enumerate(zip(fake_feats_g, real_feats)):
                l_fm += fm_crit(ff, jax.lax.stop_gradient(rf)) / jcfg.fm_layer_norm[i]
            loss += jcfg.fm_weight * l_fm
        return loss + jcfg.gan_weight * gan_crit(fake_logits_g, True)

    return prepare, d_loss, g_loss


# (name, config overrides, T): GAN and LSGAN, with and without ping-pong,
# feature matching and the VGG feature loss, both D types
LOSS_CASES = [
    ("st_all", dict(), 4, True),
    ("st_lsgan_no_pp", dict(gan_crit="LSGAN", use_pingpong=False, use_feature_matching=False), 4, False),
    ("st_no_fm_feat", dict(use_feature_matching=False), 3, True),
    ("spatial_cond", dict(disc_type="spatial", use_cond=True, gan_crit="LSGAN"), 3, True),
    ("spatial_no_pp", dict(disc_type="spatial", use_pingpong=False), 3, False),
]


def _jax64_grads(jcfg, vgg_sd, gp, dp, lr, gt):
    """The D and the G gradients of the JAX package's losses evaluated in
    float64 (its warp samples in float32 either way)."""
    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), _np(tree))

    with jax.enable_x64(True):
        jfx = None
        if vgg_sd is not None:
            jfx = jvgg.VGGFeatureExtractor({k: v.astype(np.float64) for k, v in vgg_sd.items()})
        prepare, d_loss, g_loss = _jax_losses(jcfg, jfx)
        ctx = jax.jit(prepare)(f64(gp), jnp.asarray(lr, jnp.float64), jnp.asarray(gt, jnp.float64))
        (_, aux), g_d = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(f64(dp), ctx)
        _, g_g = jax.jit(jax.value_and_grad(g_loss))(f64(gp), f64(dp), ctx, aux[2], aux[3])
        return jax.tree.map(np.asarray, g_d), jax.tree.map(np.asarray, g_g)


def _seeded_pair(cfg, jcfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    gp = egvsr.init_params(gen, TINY_G)
    init = D.init_spatial if cfg.disc_type == "spatial" else D.init_spatio_temporal
    return gp, init(gen, cfg.disc_cfg)


@pytest.mark.parametrize("name,over,t,feat", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_gan_losses_and_gradients_match_jax(name, over, t, feat, vgg19_sd):
    """The D loss with every D gradient leaf, then the G loss (against the
    same D, with the D pass's real features and merged flow) with every G
    gradient leaf, against jax.value_and_grad of the JAX step's losses."""
    cfg, jcfg = _gan_cfgs(**over)
    fx = vgg.VGGFeatureExtractor(vgg19_sd, device="cpu") if feat else None
    jfx = jvgg.VGGFeatureExtractor(vgg19_sd) if feat else None
    gp, dp = _seeded_pair(cfg, jcfg)
    state = vsrgan.create_gan_state(None, cfg, params_g=gp, params_d=dp, device="cpu")
    lr, gt = _rand(10, 2, t, SIZE // 4, SIZE // 4, 3), _rand(11, 2, t, SIZE, SIZE, 3)
    losses = vsrgan.make_gan_loss_fns(cfg, fx)
    jprepare, jd_loss, jg_loss = _jax_losses(jcfg, jfx)

    ctx = losses.prepare(state.params_g, _t(lr), _t(gt))
    loss_d, aux = losses.d_loss(state.params_d, ctx)
    grads_d = torch.autograd.grad(loss_d, vsr.param_leaves(state.params_d), allow_unused=True)
    jctx = jax.jit(jprepare)(_j(gp), jnp.asarray(lr), jnp.asarray(gt))
    (jl_d, (jreal, jfake, jreal_feats, jflow)), jg_d = jax.jit(jax.value_and_grad(jd_loss, has_aux=True))(_j(dp), jctx)
    np.testing.assert_allclose(float(loss_d.detach()), float(jl_d), rtol=LOSS_REL)
    np.testing.assert_allclose(aux["real_logits"].numpy(), np.asarray(jreal), rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux["fake_logits"].numpy(), np.asarray(jfake), rtol=0, atol=1e-4)
    _assert_grads_close(dp, grads_d, jg_d, lambda: _jax64_grads(jcfg, vgg19_sd if feat else None, gp, dp, lr, gt)[0])
    unused = dp["body"]["blocks"][0]["conv"]["b"]
    assert [g for p, g in zip(vsr.param_leaves(dp), grads_d) if p is unused] == [None]

    loss_g, logs = losses.g_loss(state.params_g, state.params_d, ctx, aux)
    grads_g = torch.autograd.grad(loss_g, vsr.param_leaves(state.params_g), allow_unused=True)
    jl_g, jg_g = jax.jit(jax.value_and_grad(jg_loss))(_j(gp), _j(dp), jctx, jreal_feats, jflow)
    np.testing.assert_allclose(float(loss_g.detach()), float(jl_g), rtol=LOSS_REL)
    assert float(logs["l_total_G"]) == float(loss_g.detach())
    assert ("l_feat_G" in logs) == feat and ("l_pp_G" in logs) == cfg.use_pingpong
    assert ("l_fm_G" in logs) == cfg.use_feature_matching
    _assert_grads_close(gp, grads_g, jg_g, lambda: _jax64_grads(jcfg, vgg19_sd if feat else None, gp, dp, lr, gt)[1])
    # D collected nothing of either loss
    assert all(p.grad is None for p in vsr.param_leaves(state.params_d))


def _jax_state(jcfg, gp, dp):
    tx_g = optax.adam(jcfg.lr_g, b1=jcfg.beta1, b2=jcfg.beta2)
    tx_d = optax.adam(jcfg.lr_d, b1=jcfg.beta1, b2=jcfg.beta2)
    jg, jd = _j(gp), _j(dp)
    return jvsrgan.GANTrainState(jg, jd, tx_g.init(jg), tx_d.init(jd), jnp.zeros((), jnp.int32),
                                 jnp.zeros((), jnp.int32))


def _assert_updates_close(before, after_port, after_jax, rel=1e-2):
    """Each leaf's update ||d_port - d_jax|| <= rel ||d_jax||.  Adam's
    first updates are the rate times about g / (|g| + eps), the sign of
    g: the few elements whose gradient lies near zero move by visibly
    different amounts, even in opposite directions, when the gradients
    agree at 1e-4, so the moments below carry the precise check."""
    for (path, b), (_, a), (_, w) in zip(*(jax.tree_util.tree_flatten_with_path(_np(x))[0]
                                          for x in (before, after_port, after_jax))):
        b = b.astype(np.float64)
        d_port, d_jax = a - b, np.asarray(w, np.float64) - b
        assert np.linalg.norm(d_port - d_jax) <= rel * np.linalg.norm(d_jax) + 1e-12, jax.tree_util.keystr(path)


def _assert_moments_close(opt, params, jopt, rel):
    """Adam's first and second moments and its count against optax's
    ScaleByAdamState (mu, nu, count), leaf by leaf at `rel`; a leaf the
    port's Adam never stepped (a None gradient) reads as zeros."""
    jadam = jopt[0]
    leaves = vsr.param_leaves(params)
    for key, jtree in (("exp_avg", jadam.mu), ("exp_avg_sq", jadam.nu)):
        got = [opt.state[p][key] if p in opt.state else torch.zeros_like(p) for p in leaves]
        errs = _leaf_errors(params, got, jtree)
        assert max(e for _, e in errs) <= rel, (key, max(errs, key=lambda e: e[1]))
    counts = {int(st["step"]) for st in opt.state.values()}
    assert counts <= {int(jadam.count)}


@pytest.mark.parametrize("policy,threshold,updates_d", [
    ("always", 0.4, True), ("adaptive", 1e9, True), ("adaptive", -1e9, False)],
    ids=["always", "adaptive", "forced_skip"])
def test_gan_step_matches_the_jax_step(policy, threshold, updates_d):
    """One whole step of each package from the same weights: both
    networks' parameters after it, cnt_upd_d, and the logs.  A skipped D
    update leaves D's parameters and Adam state as they were."""
    lr_rate = 1e-3
    cfg, jcfg = _gan_cfgs(update_policy=policy, update_threshold=threshold, lr_g=lr_rate, lr_d=lr_rate)
    gp, dp = _seeded_pair(cfg, jcfg, seed=2)
    lr, gt = _rand(20, 2, 3, SIZE // 4, SIZE // 4, 3), _rand(21, 2, 3, SIZE, SIZE, 3)
    state = vsrgan.create_gan_state(None, cfg, params_g=gp, params_d=dp, device="cpu")
    state, logs = vsrgan.make_gan_train_step(cfg)(state, _t(lr), _t(gt))
    jstate, jlogs = jax.jit(jvsrgan.make_gan_train_step(jcfg))(_jax_state(jcfg, gp, dp), jnp.asarray(lr),
                                                               jnp.asarray(gt))
    assert state.step == int(jstate.step) == 1
    assert state.cnt_upd_d == int(jstate.cnt_upd_d) == int(updates_d)
    _assert_moments_close(state.opt_g, state.params_g, jstate.opt_g, 1e-4)
    _assert_moments_close(state.opt_d, state.params_d, jstate.opt_d, 1e-4)
    _assert_updates_close(gp, state.params_g, jstate.params_g)
    _assert_updates_close(dp, state.params_d, jstate.params_d)
    if not updates_d:
        for a, b in zip(vsr.param_leaves(state.params_d), vsr.param_leaves(dp)):
            assert torch.equal(a.detach(), b)
        assert state.opt_d.state_dict()["state"] == {}
        assert float(logs["l_gan_D"]) == float(jlogs["l_gan_D"]) == 0.0
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_gan_rates_are_fixed_whatever_the_schedule():
    """The JAX GAN step updates with a fixed-rate Adam even when its state
    was built from a schedule (here one that cuts the rate 100x after the
    first update): two of its steps equal two of the port's, whose rates
    stay cfg.lr_g and cfg.lr_d."""
    lr_rate = 1e-3
    cfg, jcfg = _gan_cfgs(lr_g=lr_rate, lr_d=2 * lr_rate, update_policy="always")
    gp, dp = _seeded_pair(cfg, jcfg, seed=3)
    sched = optax.piecewise_constant_schedule(lr_rate, {1: 0.01})
    batches = [(_rand(30 + i, 1, 3, SIZE // 4, SIZE // 4, 3), _rand(40 + i, 1, 3, SIZE, SIZE, 3)) for i in range(2)]
    jstate = jvsrgan.create_gan_state(jax.random.PRNGKey(0), jcfg, sched, sched)
    jstate = jstate._replace(params_g=_j(gp), params_d=_j(dp), opt_g=optax.adam(sched).init(_j(gp)),
                             opt_d=optax.adam(sched).init(_j(dp)))
    jstep = jax.jit(jvsrgan.make_gan_train_step(jcfg, sched_g=sched, sched_d=sched))
    state = vsrgan.create_gan_state(None, cfg, params_g=gp, params_d=dp, device="cpu")
    step = vsrgan.make_gan_train_step(cfg)
    for lr, gt in batches:
        jstate, _ = jstep(jstate, jnp.asarray(lr), jnp.asarray(gt))
        state, _ = step(state, _t(lr), _t(gt))
    assert [g["lr"] for g in state.opt_g.param_groups] == [lr_rate]
    assert [g["lr"] for g in state.opt_d.param_groups] == [2 * lr_rate]
    _assert_moments_close(state.opt_g, state.params_g, jstate.opt_g, 1e-3)
    _assert_updates_close(gp, state.params_g, jstate.params_g)
    _assert_updates_close(dp, state.params_d, jstate.params_d)


# ------------------------------------------------------------------ driver


@pytest.fixture(scope="module")
def derived(tmp_path_factory):
    """A tiny derived dataset: 4 panned 3-frame sequences of 48x48 GT
    (12x12 LR) from seeded stills and a 3-frame val sequence."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    root = tmp_path_factory.mktemp("gan_derived")
    mdd.write_stills(str(root / "stills"), 3, 64, seed=2)
    mdd.main(["--src", str(root / "stills"), "--out", str(root / "data"), "--holdout", "still_000.png",
              "--seqs", "4", "--tempo", "3", "--crop", "48", "--pan", "4", "--val-tempo", "3"])
    return root


def _gan_config(root, name="gan", disc="STNet"):
    """configs/tecogan_bd.yml's recipe at a tiny size: BD degradation, a
    GT crop of 32 (40 with the blur's border), FRNet nf 16 / nb 1, all
    five losses, the adaptive D."""
    data = root / "data"
    return {
        "scale": 4,
        "manual_seed": 0,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "Folder", "gt_seq_dir": str(data / "train" / "GT"),
                      "lr_seq_dir": str(data / "train" / "LR"), "crop_size": SIZE, "batch_size": 2,
                      "num_workers": 0},
            "test1": {"gt_seq_dir": str(data / "val" / "GT"), "lr_seq_dir": str(data / "val" / "LR")},
        },
        "model": {"generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 16, "nb": 1},
                  "discriminator": {"name": disc, "in_nc": 3, "tempo_range": 3}},
        "train": {
            "tempo_extent": 3, "total_iter": 3, "ckpt_freq": 2, "ckpt_dir": str(root / f"ckpt_{name}"),
            "resume": True,
            "pixel_crit": {"type": "CB", "weight": 1}, "warping_crit": {"type": "CB", "weight": 1},
            "pingpong_crit": {"type": "CB", "weight": 0.5}, "feature_matching_crit": {"type": "CB", "weight": 1},
            "gan_crit": {"type": "GAN", "weight": 0.01},
            "generator": {"lr": 5e-5},
            "discriminator": {"lr": 5e-5, "update_policy": "adaptive", "update_threshold": 0.4,
                              "crop_border_ratio": 0.75},
        },
        "test": {"test_freq": 0, "metrics": ["PSNR"], "psnr_colorspace": "y", "profile_size": [16, 16]},
        "logger": {"log_freq": 1},
    }


def _write(path, opt):
    import yaml

    path.write_text(yaml.safe_dump(opt))
    return str(path)


def test_driver_gan_train_resume_test_on_the_cpu(derived):
    """main(--mode train) for 3 iterations (checkpoints at 2 and 3), then
    on to 4 from the newest checkpoint, then --mode test and --mode
    profile from the run's checkpoints (the generator's parameters)."""
    opt = _gan_config(derived)
    cfg = _write(derived / "gan.yml", opt)
    res = driver.main(["--config", cfg, "--mode", "train", "--device", "cpu"])
    assert res["iter"] == 3 and len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["losses"] == res["logs"]["l_total_G"]
    assert {"l_pix_G", "l_warp_G", "l_pp_G", "l_fm_G", "l_gan_G", "l_gan_D", "distance"} <= set(res["logs"])
    assert 0 <= res["cnt_upd_d"] <= 3
    assert sum(v != 0.0 for v in res["logs"]["l_gan_D"]) == res["cnt_upd_d"]
    assert [os.path.basename(p) for p in res["checkpoints"]] == ["ckpt_000000002", "ckpt_000000003"]
    blob = torch.load(res["checkpoints"][-1], weights_only=True)
    assert sorted(blob) == ["cnt_upd_d", "opt_d", "opt_g", "params_d", "params_g", "step"]

    opt["train"]["total_iter"] = 4
    res = driver.main(["--config", _write(derived / "gan.yml", opt), "--mode", "train", "--device", "cpu"])
    assert os.path.basename(res["resumed_from"]) == "ckpt_000000003" and res["iter"] == 4

    opt["model"]["generator"]["load_path"] = opt["train"]["ckpt_dir"]
    cfg = _write(derived / "gan_test.yml", opt)
    res = driver.main(["--config", cfg, "--mode", "test", "--device", "cpu"])
    assert np.isfinite(res["test1"]["PSNR"])
    stats = driver.main(["--config", cfg, "--mode", "profile", "--device", "cpu"])
    assert stats["flops"] > 0 and stats["params"] == sum(
        p.numel() for p in vsr.param_leaves(checkpoint.load_params(checkpoint.latest_checkpoint(
            opt["train"]["ckpt_dir"]))))


@pytest.mark.parametrize("disc", ["STNet", "SNet"])
def test_driver_gan_resume_is_bit_identical(derived, tmp_path, disc):
    """The driver's GAN recipe on four of its batches: four steps straight
    against two, a checkpoint, a fresh state restored from it and two
    more, bit for bit: both networks, both Adams, step and cnt_upd_d."""
    opt = _gan_config(derived, disc=disc)
    degrade = driver.make_degrade(opt, "cpu")
    batches = []
    while len(batches) < 4:
        batches += [degrade(torch.from_numpy(b["gt"])) for b in driver.train_loader(opt)]

    straight = driver.build_training(opt, "cpu")
    for b in batches[:4]:
        straight.step(straight.state, b["lr"], b["gt"])
    first = driver.build_training(opt, "cpu")
    for b in batches[:2]:
        first.step(first.state, b["lr"], b["gt"])
    path = checkpoint.save_checkpoint(str(tmp_path), first.state, first.state.step)
    opt["manual_seed"] = 1  # the fresh state's own weights differ
    resumed = driver.build_training(opt, "cpu")
    checkpoint.load_checkpoint(path, resumed.state)
    for b in batches[2:4]:
        resumed.step(resumed.state, b["lr"], b["gt"])

    a, b = resumed.state, straight.state
    assert a.step == b.step == 4 and a.cnt_upd_d == b.cnt_upd_d
    for tree in ("params_g", "params_d"):
        for x, y in zip(vsr.param_leaves(getattr(a, tree)), vsr.param_leaves(getattr(b, tree))):
            assert torch.equal(x, y), tree
    for opt_name in ("opt_g", "opt_d"):
        sa, sb = getattr(a, opt_name).state_dict(), getattr(b, opt_name).state_dict()
        assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
        for k in sb["state"]:
            for key, v in sb["state"][k].items():
                assert torch.equal(sa["state"][k][key], v), (opt_name, k, key)


def test_driver_builds_the_vgg_loss_from_a_weights_file(derived, tmp_path, vgg19_sd):
    """train.feature_crit.vgg_weights names a torchvision vgg19 state dict:
    the step then logs the feature loss; without it, none."""
    path = tmp_path / "vgg19.pth"
    torch.save({k: torch.from_numpy(v) for k, v in vgg19_sd.items()}, path)
    opt = _gan_config(derived, disc="SNet")
    opt["model"]["discriminator"]["use_cond"] = True
    batch = driver.make_degrade(opt, "cpu")(torch.from_numpy(next(iter(driver.train_loader(opt)))["gt"]))
    recipe = driver.build_training(opt, "cpu")
    assert "l_feat_G" not in recipe.step(recipe.state, batch["lr"], batch["gt"])[1]
    opt["train"]["feature_crit"] = {"type": "CB", "weight": 0.2, "vgg_weights": str(path)}
    recipe = driver.build_training(opt, "cpu")
    assert recipe.cfg.disc_type == "spatial" and recipe.cfg.disc_cfg.use_cond
    assert recipe.cfg.disc_cfg.spatial_size == SIZE
    logs = recipe.step(recipe.state, batch["lr"], batch["gt"])[1]
    assert np.isfinite(float(logs["l_feat_G"])) and float(logs["l_feat_G"]) > 0
