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

__all__ = ["conv2d", "prelu", "relu6", "pixel_shuffle"]


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
