"""What the three export tools (export_torch_srvgg.py, export_torch_egvsr.py,
export_torch_bsvd.py) share: find a checkpoint of this package, write a
reference-layout state dict, and read it back through the importer the
services use (torch_import.load_state_dict, then the model's
from_torch), holding every parameter equal to the checkpoint's.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from ..models.torch_import import load_state_dict
from ..train import checkpoint
from ..train.vsr import param_leaves

__all__ = ["load_checkpoint_params", "write_and_check"]


def load_checkpoint_params(path: str) -> dict:
    """The (generator's) parameters of a checkpoint file ckpt_{step:09d},
    or of the newest one in a checkpoint root, on the CPU."""
    if os.path.isdir(path):
        newest = checkpoint.latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no ckpt_* checkpoint in {path}")
        path = newest
    return checkpoint.load_params(path)


def write_and_check(params: dict, sd: dict[str, torch.Tensor], out: str, from_torch: Callable,
                    wrapper: str | None = None) -> dict:
    """torch.save `sd` to `out` (under {wrapper: sd} if given), read it
    back through load_state_dict and `from_torch`, and require every leaf
    to equal `params`' bit for bit.  Returns {'out', 'tensors', 'leaves'}."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({wrapper: sd} if wrapper else sd, out)
    back, want = param_leaves(from_torch(load_state_dict(out))), param_leaves(params)
    if len(back) != len(want):
        raise RuntimeError(f"{out}: reads back {len(back)} parameter tensors, the checkpoint has {len(want)}")
    for a, b in zip(back, want):
        if not torch.equal(a, b.detach().to("cpu", torch.float32)):
            raise RuntimeError(f"{out}: a parameter of shape {tuple(b.shape)} does not read back equal")
    return {"out": out, "tensors": len(sd), "leaves": len(want)}
