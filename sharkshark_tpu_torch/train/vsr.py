"""VSR (FRVSR/EGVSR) training step (counterpart of the JAX package's
train/vsr.py; reference models/vsr_model.py:46-119).

A TrainState holds the parameters (the model's dict of tensors, each
leaf a tensor that requires grad), a `torch.optim.Adam` (AdamW when
`weight_decay` is set) over those leaves, and the update count.  A train
step computes the loss, back-propagates, sets the learning rate to the
schedule's value at the current count (optax's convention: the first
update reads sched(0)) and steps the optimizer, in place.

Loss: the weighted Charbonnier pixel loss on the HR sequence plus the
warping loss crit(backward_warp(lr_prev, lr_flow), lr_curr) on the flow
that the forward pass already computed (vsr_model.py:96-115).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models import egvsr
from ..models.torch_import import to_tensors
from ..ops.warp import backward_warp
from ..utils import resolve_device
from .losses import define_criterion

__all__ = [
    "VSRTrainConfig", "TrainState", "param_leaves", "make_optimizer", "new_train_state",
    "apply_gradients", "create_train_state", "make_loss_fn", "make_train_step",
]


class VSRTrainConfig(NamedTuple):
    model_cfg: egvsr.EGVSRConfig = egvsr.DEFAULT
    lr: float = 5e-5                      # reference train yml generator.lr
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    pixel_crit: dict | None = None        # default CB below
    warping_crit: dict | None = None      # default CB weight 1 below
    pixel_weight: float = 1.0
    warping_weight: float = 1.0


@dataclass
class TrainState:
    """params: nested dict/list of leaf tensors (requires_grad); opt: the
    optimizer over param_leaves(params), in that order; step: updates
    done so far."""

    params: dict
    opt: torch.optim.Optimizer
    step: int = 0


def param_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict/list, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def make_optimizer(leaves, lr: float, beta1: float, beta2: float, weight_decay: float = 0.0):
    """optax.adam's update (eps 1e-8 outside the square root, bias
    corrected), or optax.adamw's decoupled decay when weight_decay is
    set."""
    if weight_decay:
        return torch.optim.AdamW(leaves, lr=lr, betas=(beta1, beta2), eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(leaves, lr=lr, betas=(beta1, beta2), eps=1e-8)


def _trainable_copy(tree):
    if isinstance(tree, dict):
        return {k: _trainable_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable_copy(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def new_train_state(params: dict, device, lr: float, beta1: float, beta2: float,
                    weight_decay: float = 0.0) -> TrainState:
    """A fresh TrainState over float32 copies of `params` (tensors or
    numpy arrays, left as they are) on `device`."""
    params = _trainable_copy(to_tensors(params, resolve_device(device)))
    return TrainState(params, make_optimizer(param_leaves(params), lr, beta1, beta2, weight_decay))


def apply_gradients(state: TrainState, loss: torch.Tensor, sched: Callable[[int], float]) -> None:
    """Back-propagate `loss`, then one optimizer update at the rate
    sched(state.step), in place."""
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    lr = sched(state.step)
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.step()
    state.step += 1


def create_train_state(
    generator: torch.Generator,
    cfg: VSRTrainConfig = VSRTrainConfig(),
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Seeded FRNet weights (or `params`) and a fresh optimizer on `device`."""
    if params is None:
        params = egvsr.init_params(generator, cfg.model_cfg)
    return new_train_state(params, device, cfg.lr, cfg.beta1, cfg.beta2, cfg.weight_decay)


def make_loss_fn(cfg: VSRTrainConfig = VSRTrainConfig()):
    """Returns `loss_fn(params, lr_data, gt_data) -> (loss, logs)`, with
    its config as `loss_fn.cfg`.  parallel.make_sharded_train_step reads
    only that config: its `_band_train_losses` recomputes this loss band
    by band (forward_sequence and the two criteria), so a change here
    needs the same change there."""
    pix_crit = define_criterion(cfg.pixel_crit or {"type": "CB"})
    warp_crit = define_criterion(cfg.warping_crit or {"type": "CB"})

    def loss_fn(params, lr_data, gt_data):
        out = egvsr.forward_sequence(params, lr_data, cfg=cfg.model_cfg)
        loss_pix = cfg.pixel_weight * pix_crit(out["hr_data"], gt_data)
        lr_warp = backward_warp(out["lr_prev"], out["lr_flow"])
        loss_warp = cfg.warping_weight * warp_crit(lr_warp, out["lr_curr"])
        loss = loss_pix + loss_warp
        return loss, {"l_pix_G": loss_pix, "l_warp_G": loss_warp, "l_total": loss}

    loss_fn.cfg = cfg
    return loss_fn


def make_train_step(cfg: VSRTrainConfig = VSRTrainConfig(), schedule: Callable | None = None):
    """Returns `train_step(state, lr_data, gt_data) -> (state, logs)`,
    which updates `state` in place and returns it with detached logs.
    The step exposes its loss function and its schedule as
    `train_step.loss_fn` and `train_step.schedule`, which
    parallel.make_sharded_train_step reads (a jitted JAX function is
    transparent to its sharding; a closure is not).

    lr_data: (N, T, h, w, C) in [0,1]; gt_data: (N, T, h*s, w*s, C)."""
    sched = schedule or (lambda step: cfg.lr)
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, lr_data, gt_data):
        loss, logs = loss_fn(state.params, lr_data, gt_data)
        apply_gradients(state, loss, sched)
        return state, {k: v.detach() for k, v in logs.items()}

    train_step.loss_fn, train_step.schedule = loss_fn, sched
    return train_step
