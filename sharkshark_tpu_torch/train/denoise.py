"""BSVD denoise training step (counterpart of the JAX package's
train/denoise.py).

The reference ships BSVD pre-trained only (src/upscale/model/bsvd/
factory.py:38-83); this recipe trains the production architecture on
clean clips with synthetic noise (blind Gaussian, the BSVD/FastDVDnet
formulation): per clip sigma ~ U[sigma_min, sigma_max), N(0, sigma^2)
added to the clean frames, and [noisy RGB | constant sigma noise map]
as the input, the layout the denoise service feeds at inference.

Forward = one layer-major `bsvd.chunk_step` over the clip and SHIFT_NUM
zero flush frames with t_end=T, cold, on the library route for the
temporal-shift convs (`shift_conv="library"`: float32 and a backward,
which K1 has not).  Loss = Charbonnier(denoised, clean).

The noise of step k comes from a torch.Generator on the data's device
seeded from (noise_seed, k), so that a run resumed at step k draws the
same noise as an uninterrupted one.  The JAX package draws it with
jax.random.fold_in(PRNGKey(noise_seed), k): the two streams differ.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import bsvd
from .compiled import SplitStep, eager_step
from .losses import define_criterion
from .vsr import TrainState, count_update, new_train_state, optimizer_update, set_rate

__all__ = [
    "DenoiseTrainConfig",
    "clip_forward",
    "noise_generator",
    "noisy_input",
    "create_denoise_state",
    "make_denoise_loss_fn",
    "make_denoise_train_step",
]


class DenoiseTrainConfig(NamedTuple):
    model_cfg: bsvd.BSVDConfig = bsvd.BSVD_32
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    pixel_crit: dict | None = None       # default Charbonnier
    pixel_weight: float = 1.0
    sigma_min: float = 10.0 / 255.0      # blind-noise training range
    sigma_max: float = 50.0 / 255.0
    noise_seed: int = 0


def clip_forward(params: dict, x: torch.Tensor, *, cfg: bsvd.BSVDConfig = bsvd.BSVD_32) -> torch.Tensor:
    """Denoise a clip in one batched chunk pass on the library route.

    x: (T, N, H, W, in_ch) -> (T, N, H, W, out_ch).  Every conv sees the
    whole (T + SHIFT_NUM) * N batch."""
    t, n, h, w, _ = x.shape
    pad = x.new_zeros((bsvd.SHIFT_NUM,) + tuple(x.shape[1:]))
    state = bsvd.init_chunk_state(n, h, w, cfg, x.dtype, x.device)
    y, _ = bsvd.chunk_step(params, state, torch.cat([x, pad]), cfg=cfg, t_end=t, shift_conv="library")
    return y[bsvd.SHIFT_NUM :]


def noise_generator(noise_seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s noise, on `device`."""
    seed = int(np.random.SeedSequence([noise_seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def noisy_input(cfg: DenoiseTrainConfig, gt: torch.Tensor, step: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(noisy RGB | sigma noise map, sigma) for clean gt (N, T, H, W, 3)."""
    g = noise_generator(cfg.noise_seed, step, gt.device)
    n = gt.shape[0]
    u = torch.rand((n, 1, 1, 1, 1), generator=g, device=gt.device, dtype=gt.dtype)
    sigma = cfg.sigma_min + (cfg.sigma_max - cfg.sigma_min) * u
    noisy = gt + sigma * torch.randn(gt.shape, generator=g, device=gt.device, dtype=gt.dtype)
    nmap = sigma.expand(*gt.shape[:-1], 1)
    return torch.cat([noisy, nmap], dim=-1), sigma


def create_denoise_state(
    generator: torch.Generator,
    cfg: DenoiseTrainConfig = DenoiseTrainConfig(),
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    if params is None:
        params = bsvd.init_params(generator, cfg.model_cfg)
    return new_train_state(params, device, cfg.lr, cfg.beta1, cfg.beta2)


def make_denoise_loss_fn(cfg: DenoiseTrainConfig = DenoiseTrainConfig()):
    """Returns `loss_fn(params, noisy4, gt_data) -> (loss, logs)`, with
    noisy4 (N, T, H, W, 4) and gt_data (N, T, H, W, 3)."""
    pix_crit = define_criterion(cfg.pixel_crit or {"type": "CB"})

    def loss_fn(params, noisy4, gt_data):
        # (N,T,H,W,C) -> chunk layout (T,N,H,W,C) and back
        out = clip_forward(params, noisy4.transpose(0, 1), cfg=cfg.model_cfg).transpose(0, 1)
        loss = cfg.pixel_weight * pix_crit(out, gt_data)
        return loss, {"l_pix_G": loss, "l_total": loss}

    return loss_fn


def make_denoise_train_step(cfg: DenoiseTrainConfig = DenoiseTrainConfig(), schedule: Callable | None = None):
    """Returns `train_step(state, lr_data, gt_data) -> (state, logs)`, in
    place and split as train/vsr.py's.  lr_data is ignored (denoising
    keeps the resolution: the config pairs the GT dir with itself at
    scale 1); gt_data: (N, T, H, W, 3) clean in [0,1].  The noise is
    drawn in the host prologue (its generator is seeded from the host
    step), so the noisy clip and sigma enter the body as inputs."""
    sched = schedule or (lambda step: cfg.lr)
    loss_fn = make_denoise_loss_fn(cfg)

    def prologue(state: TrainState, lr_data, gt_data):
        set_rate(state.opt, sched(state.step))
        noisy4, sigma = noisy_input(cfg, gt_data, state.step)
        return noisy4, gt_data, sigma

    def body(state: TrainState, noisy4, gt_data, sigma):
        loss, logs = loss_fn(state.params, noisy4, gt_data)
        optimizer_update(state.opt, loss)
        logs = {k: v.detach() for k, v in logs.items()}
        logs["sigma_mean"] = sigma.mean()
        return logs

    return eager_step(SplitStep(prologue, body, count_update))
