"""Training criteria for the VSR training tree (counterpart of the JAX
package's train/losses.py).

Charbonnier (robust L1), MSE, cosine similarity and the two GAN
objectives (vanilla BCE-with-logits, least squares), with the criterion
registry of the reference (src/upscale/model/egvsr/models/optim/
losses.py:6-65, optim/__init__.py:5-35).  All are functions of tensors;
activations are channel-last, as everywhere in this package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "charbonnier_loss",
    "mse_loss",
    "cosine_similarity_loss",
    "vanilla_gan_loss",
    "lsgan_loss",
    "define_criterion",
    "criterion_parts",
]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    return loss.sum() if reduction == "sum" else loss.mean()


def charbonnier_loss(x, y, eps: float = 1e-6, reduction: str = "sum"):
    diff = x - y
    return _reduce(torch.sqrt(diff * diff + eps), reduction)


def mse_loss(x, y, reduction: str = "mean"):
    return _reduce((x - y) ** 2, reduction)


def cosine_similarity_loss(x, y, eps: float = 1e-8, axis: int = -1):
    """1 - mean cosine similarity along `axis` (the reference uses NCHW's
    channel dim; channel-last here)."""
    dot = (x * y).sum(dim=axis)
    nx = torch.linalg.vector_norm(x, dim=axis)
    ny = torch.linalg.vector_norm(y, dim=axis)
    return 1.0 - (dot / torch.clamp(nx * ny, min=eps)).mean()


def vanilla_gan_loss(logits, status: bool, reduction: str = "mean"):
    target = torch.full_like(logits, float(bool(status)))
    return F.binary_cross_entropy_with_logits(logits, target, reduction=reduction)


def lsgan_loss(logits, status: bool, reduction: str = "mean"):
    return mse_loss(logits, torch.full_like(logits, float(bool(status))), reduction)


_REGISTRY = {
    "CB": charbonnier_loss,
    "MSE": mse_loss,
    "CosineSimilarity": cosine_similarity_loss,
    "GAN": vanilla_gan_loss,
    "LSGAN": lsgan_loss,
}


def define_criterion(crit_opt: dict | None, reduction: str | None = None):
    """The criterion a config block names (reference optim/__init__.py:
    5-35), with the block's other keys but `type` and `weight` as keyword
    arguments; None for a missing block.  `reduction`, where given,
    replaces the block's (criterion_parts asks for "sum")."""
    if crit_opt is None:
        return None
    name = crit_opt["type"]
    if name not in _REGISTRY:
        raise ValueError(f"unknown criterion: {name}")
    fn = _REGISTRY[name]
    kwargs = {k: v for k, v in crit_opt.items() if k not in ("type", "weight")}
    if reduction is not None:
        kwargs["reduction"] = reduction

    def crit(x, y):
        return fn(x, y, **kwargs)

    return crit


# the criteria that are a sum or a mean over elements of (x - y), each
# with its default reduction (charbonnier_loss's and mse_loss's)
_ELEMENTWISE = {"CB": "sum", "MSE": "mean"}


def criterion_parts(crit_opt: dict):
    """The criterion a config block names, split over parts of its
    inputs: (part, mean), with part(x, y) the criterion's terms summed
    over a part's elements and `mean` whether the whole criterion divides
    that sum by the whole input's element count (its reduction is not
    "sum").  Raises ValueError for a criterion that is no sum or mean
    over elements (CosineSimilarity, the GAN objectives)."""
    name = crit_opt["type"]
    if name not in _ELEMENTWISE:
        raise ValueError(f"criterion {name!r} does not split over parts of its inputs "
                         f"(only the sums and means over elements do: {', '.join(_ELEMENTWISE)})")
    return define_criterion(crit_opt, reduction="sum"), crit_opt.get("reduction", _ELEMENTWISE[name]) != "sum"
