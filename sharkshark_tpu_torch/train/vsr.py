"""VSR (FRVSR/EGVSR) training step (counterpart of the JAX package's
train/vsr.py; reference models/vsr_model.py:46-119).

A TrainState holds the parameters (the model's dict of tensors, each
leaf a tensor that requires grad), a `torch.optim.Adam` (AdamW when
`weight_decay` is set) over those leaves, and the update count.  A train
step sets the learning rate to the schedule's value at the current count
(optax's convention: the first update reads sched(0)), computes the
loss, back-propagates and steps the optimizer, in place.

Each recipe's step is split in three (train/compiled.py::SplitStep): a
host prologue (the rate, anything seeded on the host), a device body
(loss, backward, optimizer update) and a host epilogue (the count).
The driver captures the body of each input signature into a CUDA graph,
as the JAX driver jits the step.  So on a CUDA device the optimizer is
graph-safe: `capturable=True`, its rate a 0-d tensor on the device that
the prologue fills in place, and its moments and counts made at once, so
that every address the graph reads exists before the capture.  On the
CPU it is the plain optimizer, its rate a Python float.

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
    "VSRTrainConfig", "TrainState", "param_leaves", "make_optimizer", "set_rate", "optimizer_update",
    "new_train_state", "apply_gradients", "create_train_state", "make_loss_fn", "make_train_step", "split_step",
    "count_update",
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
    set.  On a CUDA device it is capturable, with the rate a 0-d float32
    tensor there and every leaf's state (count 0, zero moments) made now,
    as optax.init makes it: a CUDA graph of the update then reads and
    writes them where they lie.  (Its bias correction is computed in
    float32 on the device, the plain optimizer's in float64 on the host.)"""
    cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
    kw = {"weight_decay": weight_decay} if weight_decay else {}
    dev = leaves[0].device
    if dev.type != "cuda":
        return cls(leaves, lr=lr, betas=(beta1, beta2), eps=1e-8, **kw)
    opt = cls(leaves, lr=torch.tensor(lr, dtype=torch.float32, device=dev), betas=(beta1, beta2), eps=1e-8,
              capturable=True, **kw)
    for p in leaves:
        opt.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=dev),
                        "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
    return opt


def set_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's rate: a tensor rate is filled in place (a CUDA
    graph reads it where it lies; assigning a float would replace it), a
    float one replaced."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def optimizer_update(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """Back-propagate `loss` into gradients set anew (never added to the
    last step's: under a CUDA graph's capture they are allocated from its
    pool, and each replay overwrites them), then one optimizer step.  The
    gradients stay on the leaves."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


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
    sched(state.step), in place: a whole step's three parts in one call,
    run eagerly."""
    set_rate(state.opt, sched(state.step))
    optimizer_update(state.opt, loss)
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
    The step exposes its three parts as `train_step.split` (what
    train/compiled.py captures), and its loss function and its schedule as
    `train_step.loss_fn` and `train_step.schedule`, which
    parallel.make_sharded_train_step reads (a jitted JAX function is
    transparent to its sharding; a closure is not).

    lr_data: (N, T, h, w, C) in [0,1]; gt_data: (N, T, h*s, w*s, C)."""
    sched = schedule or (lambda step: cfg.lr)
    loss_fn = make_loss_fn(cfg)
    train_step = split_step(loss_fn, sched)
    train_step.loss_fn, train_step.schedule = loss_fn, sched
    return train_step


def split_step(loss_fn: Callable, sched: Callable[[int], float]):
    """The step of a TrainState recipe whose loss is loss_fn(params, x,
    gt) -> (loss, logs) on the batch as given: the prologue sets the rate
    sched(state.step), the body computes the loss and updates, the
    epilogue counts the update."""
    from .compiled import SplitStep, eager_step

    def prologue(state: TrainState, lr_data, gt_data):
        set_rate(state.opt, sched(state.step))
        return lr_data, gt_data

    def body(state: TrainState, lr_data, gt_data):
        loss, logs = loss_fn(state.params, lr_data, gt_data)
        optimizer_update(state.opt, loss)
        return {k: v.detach() for k, v in logs.items()}

    return eager_step(SplitStep(prologue, body, count_update))


def count_update(state) -> None:
    """The epilogue of every recipe's step: one update more."""
    state.step += 1
