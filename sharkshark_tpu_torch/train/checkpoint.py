"""Training checkpoint save and resume (counterpart of the JAX package's
train/checkpoint.py).

A checkpoint is one `torch.save` file holding the whole train state,
field by field: each parameter tree, each optimizer's state dict (Adam's
moments and counts) and the counts (a TrainState's params / opt / step;
a GAN state's params_g / params_d / opt_g / opt_d / step / cnt_upd_d),
so that a resumed run continues exactly where the saved one stood (the
reference leaves save_training_state a TODO, models/base_model.py:78-89).  Files are named `ckpt_{step:09d}` under
the run's root, as the JAX package names its orbax directories, so
`latest_checkpoint` orders both the same way.  They load with
`weights_only=True`.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from .vsr import param_leaves

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "latest_checkpoint"]


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"ckpt_{step:09d}")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def save_checkpoint(root: str, state, step: int) -> str:
    """Write `state` (a TrainState or a GANTrainState) as
    ckpt_{step:09d} under `root`."""
    path = _ckpt_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.optim.Optimizer):
            v = v.state_dict()
        elif isinstance(v, (dict, list)):
            v = _detached(v)
        blob[f.name] = v
    torch.save(blob, path)
    return path


def load_params(path: str) -> dict:
    """The (generator's) parameter tree of a checkpoint, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["params"] if "params" in ckpt else ckpt["params_g"]


def _copy_params(path: str, dst_tree, src_tree) -> None:
    dst, src = param_leaves(dst_tree), param_leaves(src_tree)
    if len(dst) != len(src):
        raise ValueError(f"{path}: {len(src)} parameter tensors, the recipe has {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f"{path}: a parameter of shape {tuple(s.shape)}, the recipe's is {tuple(d.shape)}")
            d.copy_(s)


def load_checkpoint(path: str, template):
    """Restore a checkpoint into `template` (a fresh state of the same
    recipe, which gives the structure and the device), in place."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(ckpt) != sorted(names):
        raise ValueError(f"{path}: holds {sorted(ckpt)}, the recipe's state has {sorted(names)}")
    for name in names:
        v = getattr(template, name)
        if isinstance(v, torch.optim.Optimizer):
            v.load_state_dict(ckpt[name])
        elif isinstance(v, (dict, list)):
            _copy_params(path, v, ckpt[name])
        else:
            setattr(template, name, int(ckpt[name]))
    return template


def latest_checkpoint(root: str) -> str | None:
    if not os.path.isdir(root):
        return None
    ckpts = sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))
    return os.path.join(root, ckpts[-1]) if ckpts else None
