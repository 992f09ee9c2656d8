"""Training checkpoint save and resume (counterpart of the JAX package's
train/checkpoint.py).

A checkpoint is one `torch.save` file holding the whole TrainState: the
parameter tree, the optimizer's state dict (Adam's moments and counts)
and the step, so that a resumed run continues exactly where the saved
one stood (the reference leaves save_training_state a TODO,
models/base_model.py:78-89).  Files are named `ckpt_{step:09d}` under
the run's root, as the JAX package names its orbax directories, so
`latest_checkpoint` orders both the same way.  They load with
`weights_only=True`.
"""

from __future__ import annotations

import os

import torch

from .vsr import TrainState, param_leaves

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "latest_checkpoint"]


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"ckpt_{step:09d}")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def save_checkpoint(root: str, state: TrainState, step: int) -> str:
    path = _ckpt_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"params": _detached(state.params), "opt": state.opt.state_dict(), "step": state.step}, path)
    return path


def load_params(path: str) -> dict:
    """The parameter tree of a checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint into `template` (a fresh TrainState of the same
    recipe, which gives the structure and the device), in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    dst, src = param_leaves(template.params), param_leaves(ckpt["params"])
    if len(dst) != len(src):
        raise ValueError(f"{path}: {len(src)} parameter tensors, the recipe has {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f"{path}: a parameter of shape {tuple(s.shape)}, the recipe's is {tuple(d.shape)}")
            d.copy_(s)
    template.opt.load_state_dict(ckpt["opt"])
    template.step = int(ckpt["step"])
    return template


def latest_checkpoint(root: str) -> str | None:
    if not os.path.isdir(root):
        return None
    ckpts = sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))
    return os.path.join(root, ckpts[-1]) if ckpts else None
