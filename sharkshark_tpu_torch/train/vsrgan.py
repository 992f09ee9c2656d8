"""VSR GAN (TecoGAN-style) training step (counterpart of the JAX package's
train/vsrgan.py; reference models/vsrgan_model.py:26-316).

A GANTrainState holds the generator's and the discriminator's
parameters, an Adam over each (train/vsr.py::make_optimizer), the update
count and the number of D updates.  One `train_step(state, lr_data,
gt_data)` runs, in the JAX step's order: the bicubic conditional input,
the ping-pong sequence (forward + reversed, vsrgan_model.py:137-147),
one G forward outside autograd, the D loss on the real and the detached
fake sequence, the D update, then the G loss (pixel + warping +
optional VGG feature + ping-pong + feature matching + GAN) against the
updated D with the real features of the D before its update, and the G
update.  It updates `state` in place.

- The adaptive D policy (vsrgan_model.py:193-215) skips the D update
  when D is too strong: distance = mean log sigmoid(real) - mean log
  sigmoid(fake) >= update_threshold.  The step reads that one decision
  on the host (a synchronisation a step) and then does not step D's
  optimizer, so a skipped step leaves D's parameters and its Adam state,
  moments and count alike, as they were.  The 'always' policy reads
  nothing.
- Each loss is differentiated with torch.autograd.grad over its own
  network's leaves only, so D never collects the G loss's gradients.
- The rates are fixed at cfg.lr_g and cfg.lr_d: the JAX step updates
  with a fixed-rate Adam whatever schedule its state was built with, so
  a config's lr_schedule has no effect there, nor here.
- The warps in the losses are the plain gather backward_warp, which
  autograd runs through (K3 has no backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models import egvsr
from ..models.torch_import import to_tensors
from ..ops import resize
from ..ops.warp import backward_warp
from ..utils import resolve_device
from . import discriminators as D
from .losses import define_criterion
from .vsr import _trainable_copy, make_optimizer, param_leaves

__all__ = ["VSRGANConfig", "GANTrainState", "GANLosses", "create_gan_state", "make_gan_loss_fns",
           "make_gan_train_step"]


class VSRGANConfig(NamedTuple):
    model_cfg: egvsr.EGVSRConfig = egvsr.DEFAULT
    disc_cfg: D.DiscriminatorConfig = D.DiscriminatorConfig()
    disc_type: str = "spatio_temporal"  # 'spatial' | 'spatio_temporal'
    lr_g: float = 5e-5
    lr_d: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    pixel_weight: float = 1.0
    warping_weight: float = 1.0
    pingpong_weight: float = 0.5      # reference TecoGAN yml
    feature_weight: float = 0.2
    fm_weight: float = 1.0
    gan_weight: float = 0.01
    use_pingpong: bool = True
    use_feature_matching: bool = True
    crop_border_ratio: float = 0.75
    update_policy: str = "adaptive"   # 'adaptive' | 'always'
    update_threshold: float = 0.4
    fm_layer_norm: tuple = (12.0, 14.0, 24.0, 100.0)
    gan_crit: str = "GAN"             # 'GAN' | 'LSGAN'


@dataclass
class GANTrainState:
    """params_g / params_d: nested dicts of leaf tensors (requires_grad);
    opt_g / opt_d: Adam over param_leaves of each; step: updates done;
    cnt_upd_d: how many of them updated D."""

    params_g: dict
    params_d: dict
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    cnt_upd_d: int = 0

    @property
    def params(self) -> dict:
        """The generator's parameters: what test mode runs and a
        checkpoint's `load_params` gives."""
        return self.params_g


def create_gan_state(
    generator: torch.Generator | None,
    cfg: VSRGANConfig = VSRGANConfig(),
    params_g: dict | None = None,
    params_d: dict | None = None,
    device: str | torch.device = "cuda",
) -> GANTrainState:
    """Seeded FRNet and discriminator weights (G's drawn first, then D's,
    from `generator`; or `params_g` / `params_d`, tensors or numpy) and a
    fresh Adam for each, at the fixed rates cfg.lr_g and cfg.lr_d, on
    `device`."""
    dev = resolve_device(device)
    if params_g is None:
        params_g = egvsr.init_params(generator, cfg.model_cfg)
    if params_d is None:
        init = D.init_spatial if cfg.disc_type == "spatial" else D.init_spatio_temporal
        params_d = init(generator, cfg.disc_cfg)
    params_g = _trainable_copy(to_tensors(params_g, dev))
    params_d = _trainable_copy(to_tensors(params_d, dev))
    return GANTrainState(
        params_g, params_d,
        make_optimizer(param_leaves(params_g), cfg.lr_g, cfg.beta1, cfg.beta2),
        make_optimizer(param_leaves(params_d), cfg.lr_d, cfg.beta1, cfg.beta2),
    )


class GANLosses(NamedTuple):
    """The step's parts, each a function of tensors:

    - prepare(params_g, lr_data, gt_data) -> ctx: the bicubic conditional
      input, the ping-pong sequences and G's forward outside autograd;
    - d_loss(params_d, ctx) -> (loss, aux): aux holds the real and fake
      logits, the real features (detached), the merged flow and the
      distance the adaptive policy reads;
    - g_loss(params_g, params_d, ctx, aux) -> (loss, logs)."""

    prepare: Callable
    d_loss: Callable
    g_loss: Callable


def make_gan_loss_fns(cfg: VSRGANConfig = VSRGANConfig(), feature_extractor: Callable | None = None) -> GANLosses:
    """The step's losses.  `feature_extractor(x)` -> list of feature maps
    for the VGG perceptual loss (None leaves it out, like a config with no
    feature_crit block)."""
    pix_crit = define_criterion({"type": "CB"})
    warp_crit = define_criterion({"type": "CB"})
    pp_crit = define_criterion({"type": "CB"}) if cfg.use_pingpong else None
    fm_crit = define_criterion({"type": "CB", "reduction": "mean"}) if cfg.use_feature_matching else None
    feat_crit = define_criterion({"type": "CB", "reduction": "mean"}) if feature_extractor else None
    gan_crit = define_criterion({"type": cfg.gan_crit})
    mcfg, dcfg = cfg.model_cfg, cfg.disc_cfg

    def d_forward(params_d, data, ctx, params_g, hr_flow_merge=None):
        if cfg.disc_type == "spatial":
            logits, feats = D.spatial_forward_sequence(params_d, data, ctx["bi_data"], dcfg)
            return logits, feats, None
        return D.spatio_temporal_forward_sequence(
            params_d, data, lr_data=ctx["lr_data"], bi_data=ctx["bi_data"], hr_flow=ctx["hr_flow"],
            fnet_params=params_g["fnet"], use_pp_crit=cfg.use_pingpong,
            crop_border_ratio=cfg.crop_border_ratio, hr_flow_merge=hr_flow_merge, cfg=dcfg,
        )

    def pingpong(x):
        return torch.cat([x, torch.flip(x, dims=(1,))[:, 1:]], dim=1)

    def prepare(params_g, lr_data, gt_data):
        n, t, lh, lw, c = lr_data.shape
        gh, gw = gt_data.shape[2], gt_data.shape[3]
        # the bicubic upsampled conditional input (vsrgan_model.py:133-135)
        bi_data = resize(lr_data.reshape(n * t, lh, lw, c), (gh, gw), "bicubic").reshape(n, t, gh, gw, c)
        if cfg.use_pingpong:
            lr_data, gt_data, bi_data = pingpong(lr_data), pingpong(gt_data), pingpong(bi_data)
        with torch.no_grad():
            g_out = egvsr.forward_sequence(params_g, lr_data, cfg=mcfg)
        return {"t": t, "lr_data": lr_data, "gt_data": gt_data, "bi_data": bi_data,
                "hr_data": g_out["hr_data"], "hr_flow": g_out["hr_flow"], "params_g": params_g}

    def d_loss(params_d, ctx):
        real_logits, real_feats, flow_merge = d_forward(params_d, ctx["gt_data"], ctx, ctx["params_g"])
        fake_logits, _, _ = d_forward(params_d, ctx["hr_data"].detach(), ctx, ctx["params_g"], flow_merge)
        loss = gan_crit(real_logits, True) + gan_crit(fake_logits, False)
        with torch.no_grad():
            log_real = torch.log(torch.sigmoid(real_logits) + 1e-8).mean()
            log_fake = torch.log(torch.sigmoid(fake_logits) + 1e-8).mean()
        return loss, {"real_logits": real_logits.detach(), "fake_logits": fake_logits.detach(),
                      "real_feats": [f.detach() for f in real_feats], "flow_merge": flow_merge,
                      "distance": log_real - log_fake}

    def g_loss(params_g, params_d, ctx, aux):
        t, gt = ctx["t"], ctx["gt_data"]
        out = egvsr.forward_sequence(params_g, ctx["lr_data"], cfg=mcfg)
        hr = out["hr_data"]
        logs = {}
        loss = cfg.pixel_weight * pix_crit(hr, gt)
        logs["l_pix_G"] = loss

        lr_warp = backward_warp(out["lr_prev"], out["lr_flow"])
        l_warp = cfg.warping_weight * warp_crit(lr_warp, out["lr_curr"])
        loss = loss + l_warp
        logs["l_warp_G"] = l_warp

        if feat_crit is not None:
            gh, gw, c = gt.shape[2:]
            with torch.no_grad():
                gt_feats = feature_extractor(gt.reshape(-1, gh, gw, c))
            l_feat = 0.0
            for hf, gf in zip(feature_extractor(hr.reshape(-1, gh, gw, c)), gt_feats):
                l_feat = l_feat + feat_crit(hf, gf)
            l_feat = cfg.feature_weight * l_feat
            loss = loss + l_feat
            logs["l_feat_G"] = l_feat

        if pp_crit is not None:
            # the forward half against the reversed back half (:270-279)
            l_pp = cfg.pingpong_weight * pp_crit(hr[:, : t - 1], torch.flip(hr[:, t:], dims=(1,)))
            loss = loss + l_pp
            logs["l_pp_G"] = l_pp

        fake_logits_g, fake_feats_g, _ = d_forward(params_d, hr, ctx, params_g, aux["flow_merge"])
        if fm_crit is not None:
            l_fm = 0.0
            for i, (ff, rf) in enumerate(zip(fake_feats_g, aux["real_feats"])):
                l_fm = l_fm + fm_crit(ff, rf) / cfg.fm_layer_norm[i]
            l_fm = cfg.fm_weight * l_fm
            loss = loss + l_fm
            logs["l_fm_G"] = l_fm

        l_gan = cfg.gan_weight * gan_crit(fake_logits_g, True)
        loss = loss + l_gan
        logs["l_gan_G"] = l_gan
        logs["p_fake_G"] = fake_logits_g.mean()
        logs["l_total_G"] = loss
        return loss, logs

    return GANLosses(prepare, d_loss, g_loss)


def _update(opt: torch.optim.Optimizer, leaves: list, grads) -> None:
    """One optimizer step on `grads` (a None gradient, an unused leaf,
    is skipped by Adam: the same value optax gives from a zero gradient)."""
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    for p in leaves:
        p.grad = None


def make_gan_train_step(cfg: VSRGANConfig = VSRGANConfig(), feature_extractor: Callable | None = None):
    """Returns `train_step(state, lr_data (N,T,h,w,C), gt_data
    (N,T,H,W,C)) -> (state, logs)`, which updates `state` in place and
    returns it with detached logs (the JAX step's keys)."""
    losses = make_gan_loss_fns(cfg, feature_extractor)
    adaptive = cfg.update_policy == "adaptive"

    def train_step(state: GANTrainState, lr_data, gt_data):
        ctx = losses.prepare(state.params_g, lr_data, gt_data)
        d_leaves = param_leaves(state.params_d)
        loss_d, aux = losses.d_loss(state.params_d, ctx)
        grads_d = torch.autograd.grad(loss_d, d_leaves, allow_unused=True)
        upd_d = not adaptive or bool(aux["distance"] < cfg.update_threshold)  # the one host read
        if upd_d:
            _update(state.opt_d, d_leaves, grads_d)

        g_leaves = param_leaves(state.params_g)
        loss_g, logs = losses.g_loss(state.params_g, state.params_d, ctx, aux)
        grads_g = torch.autograd.grad(loss_g, g_leaves, allow_unused=True)
        _update(state.opt_g, g_leaves, grads_g)

        logs.update(
            l_gan_D=loss_d if upd_d else torch.zeros_like(loss_d),
            p_real_D=aux["real_logits"].mean(),
            p_fake_D=aux["fake_logits"].mean(),
            distance=aux["distance"],
        )
        state.step += 1
        state.cnt_upd_d += int(upd_d)
        return state, {k: v.detach() for k, v in logs.items()}

    return train_step
