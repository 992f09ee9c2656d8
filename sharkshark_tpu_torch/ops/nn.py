"""Core NN primitives on NHWC tensors with HWIO weights (the JAX package's
layout), computed by PyTorch's own ops.

`conv2d` views the NHWC input as a channels_last NCHW tensor (a permute,
no copy), so cuDNN runs its channels_last kernels and the output permutes
back to contiguous NHWC for free.  The TPU layout tricks of the JAX
package (pixel_shuffle_mxu, lane folding, pair folding) compute these
same functions and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "conv2d", "prelu", "leaky_relu", "relu6", "pixel_shuffle", "space_to_depth",
    "pad2d", "max_pool2",
]


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution. x: NHWC, w: HWIO (I = in_ch // groups)."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype).permute(3, 2, 0, 1),
        None if b is None else b.to(x.dtype),
        stride=stride,
        padding=padding,
        groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with per-channel alpha (last axis): x where x >= 0, else
    alpha * x, in one elementwise pass over the channels_last view."""
    return F.prelu(x.permute(0, 3, 1, 2), alpha.to(x.dtype)).permute(0, 2, 3, 1)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """x where x >= 0, else x * slope, with the slope rounded to x's dtype
    first (the JAX package multiplies by the slope as an array of x's
    dtype), then the product rounded once."""
    slope = torch.tensor(negative_slope, dtype=x.dtype).item()
    return F.leaky_relu(x, slope)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC pixel shuffle matching torch nn.PixelShuffle channel order:
    input channel index (c_out * r + dy) * r + dx -> spatial (dy, dx)."""
    n, h, w, c = x.shape
    r = factor
    c_out = c // (r * r)
    x = x.reshape(n, h, w, c_out, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # n, h, r(dy), w, r(dx), c_out
    return x.reshape(n, h * r, w * r, c_out)


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Inverse of pixel_shuffle with EGVSR's channel order (reference
    utils/net_utils.py:36-47): output channel (dy * r + dx) * c + c_in,
    block offset major."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # n, h', w', dy, dx, c
    return x.reshape(n, h // r, w // r, r * r * c)


def pad2d(x: torch.Tensor, pad: int | tuple[int, int, int, int], mode: str = "reflect") -> torch.Tensor:
    """Spatial pad of NHWC. pad: int or (left, right, top, bottom), F.pad's
    order for the last two dims; mode 'reflect', 'replicate' or 'zero'."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    tmode = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}[mode]
    lead = x.shape[:-3]
    xc = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.pad(xc, tuple(pad), mode=tmode).permute(0, 2, 3, 1)
    return y.reshape(*lead, *y.shape[-3:]).contiguous()


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID (an odd last row or column is
    dropped), on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
