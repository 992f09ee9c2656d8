"""Single-image SR training step for SRVGG (counterpart of the JAX
package's train/sisr.py).

The reference ships its SRVGG weights pre-trained (realesrgan/
factory.py:140-150); this recipe trains them locally with the same
TrainState machinery as train/vsr.py and a per-frame forward: the N*T
frames ride the batch of one `srvgg.apply`, pixel criterion only.  The
body runs layer by layer (`conv_stack=0`): cuDNN convs with autograd,
since K4 has no backward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..models import srvgg
from .losses import define_criterion
from .vsr import TrainState, new_train_state, split_step

__all__ = ["SISRTrainConfig", "create_sisr_state", "make_sisr_loss_fn", "make_sisr_train_step"]


class SISRTrainConfig(NamedTuple):
    model_cfg: srvgg.SRVGGConfig = srvgg.GENERAL_X4V3
    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    pixel_crit: dict | None = None  # default Charbonnier
    pixel_weight: float = 1.0


def create_sisr_state(
    generator: torch.Generator,
    cfg: SISRTrainConfig = SISRTrainConfig(),
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    if params is None:
        params = srvgg.init_params(generator, cfg.model_cfg)
    return new_train_state(params, device, cfg.lr, cfg.beta1, cfg.beta2)


def make_sisr_loss_fn(cfg: SISRTrainConfig = SISRTrainConfig()):
    """Returns `loss_fn(params, lr_data, gt_data) -> (loss, logs)`; frames
    fold into the batch dim."""
    pix_crit = define_criterion(cfg.pixel_crit or {"type": "CB"})

    def loss_fn(params, lr_data, gt_data):
        n, t, h, w, c = lr_data.shape
        out = srvgg.apply(params, lr_data.reshape(n * t, h, w, c), cfg=cfg.model_cfg, conv_stack=0)
        loss = cfg.pixel_weight * pix_crit(out, gt_data.reshape(n * t, *gt_data.shape[2:]))
        return loss, {"l_pix_G": loss, "l_total": loss}

    return loss_fn


def make_sisr_train_step(cfg: SISRTrainConfig = SISRTrainConfig(), schedule: Callable | None = None):
    """Returns `train_step(state, lr_data, gt_data) -> (state, logs)`, in
    place and split as train/vsr.py's.

    lr_data: (N, T, h, w, C) in [0,1] (T=1 for pure image datasets);
    gt_data: (N, T, h*s, w*s, C)."""
    return split_step(make_sisr_loss_fn(cfg), schedule or (lambda step: cfg.lr))
