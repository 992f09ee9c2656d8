"""Color and post-processing ops of the production upscale path, on NHWC
tensors (counterpart of the JAX package's ops/color.py).

- `global_color_match`  <- channel mean/std match (reference fsrcnn_upscaler.py:188-199)
- `local_color_match`   <- blur-pyramid local match (:201-218)
- `sharpen`, `blur`     <- sharpen_ker / blur_ker with reflect padding (:20-84)
- `to_float` / `to_uint8` / `to_yuv420` <- the uint8 NHWC edges
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_cache
from .resize import resize

__all__ = [
    "gaussian_kernel_2d",
    "sharpen_kernel_2d",
    "blur",
    "sharpen",
    "global_color_match",
    "local_color_match",
    "to_float",
    "to_uint8",
    "to_yuv420",
]


@lru_cache(maxsize=None)
def gaussian_kernel_2d(kernel_size: int = 3, sigma: float = 0.5) -> np.ndarray:
    """Normalized 2-D gaussian, shape (k, k)."""
    coords = np.arange(kernel_size, dtype=np.float64)
    mean = (kernel_size - 1) / 2.0
    var = sigma**2
    g1 = np.exp(-((coords - mean) ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)
    k = np.outer(g1, g1)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def sharpen_kernel_2d(strength: float = 1.0) -> np.ndarray:
    """Blend of a 3x3 sharpen stencil with identity, normalized to sum 1,
    shape (3, 3, 1, 1) (HWI1, for depthwise_conv2d)."""
    sharp = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], dtype=np.float64)
    ident = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)
    k = sharp * strength + (1.0 - strength) * ident
    k = k / k.sum()
    return k.astype(np.float32).reshape(3, 3, 1, 1)


def _reflect_pad_hw(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad (edge excluded, like torch padding_mode='reflect') the
    trailing H, W axes of an (..., H, W, C) tensor by p."""
    for axis in (x.ndim - 3, x.ndim - 2):
        n = x.shape[axis]
        lo = torch.flip(x.narrow(axis, 1, p), [axis])
        hi = torch.flip(x.narrow(axis, n - 1 - p, p), [axis])
        x = torch.cat([lo, x, hi], dim=axis)
    return x


@device_cache
def _device_kernel(kernel_size: int, sigma: float, c: int, device: torch.device, dtype: torch.dtype):
    """The depthwise gaussian weights (c, 1, k, k) on `device`."""
    k = torch.from_numpy(gaussian_kernel_2d(kernel_size, sigma)).to(device, dtype)
    return k.expand(c, 1, kernel_size, kernel_size).contiguous()


def blur(x: torch.Tensor, kernel_size: int = 3, sigma: float = 0.5) -> torch.Tensor:
    """Depthwise gaussian blur with reflect padding (NHWC)."""
    n, h, w, c = x.shape
    k = _device_kernel(kernel_size, sigma, c, x.device, x.dtype)
    xp = _reflect_pad_hw(x, kernel_size // 2).permute(0, 3, 1, 2)
    y = F.conv2d(xp, k, groups=c)
    return y.permute(0, 2, 3, 1)


def sharpen(x: torch.Tensor, strength: float) -> torch.Tensor:
    """3x3 sharpen stencil with reflect padding (NHWC):
    y = (1+8s)*x - s*sum(8 neighbours), with s first rounded to x's
    dtype (so in bf16, 1+8s rounds as well)."""
    xp = _reflect_pad_hw(x, 1)
    h, w = x.shape[-3], x.shape[-2]
    nb = None
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            t = xp[..., dy : dy + h, dx : dx + w, :]
            nb = t if nb is None else nb + t
    # the two coefficients, rounded as the JAX package rounds them (s to
    # the dtype, then 1 + 8s in the dtype), held as exact Python floats
    s = _round_to(strength, x.dtype)
    return _round_to(1 + 8 * s, x.dtype) * x - s * nb


def _round_to(v: float, dtype: torch.dtype) -> float:
    return torch.tensor(v, dtype=dtype).item()


def _chan_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image per-channel mean / unbiased std over H*W, in float32."""
    xf = x.float()
    n = x.shape[-3] * x.shape[-2]
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    var = torch.sum((xf - mean) ** 2, dim=(-3, -2), keepdim=True) / max(n - 1, 1)
    return mean, torch.sqrt(var)


def global_color_match(hr: torch.Tensor, ref_lr: torch.Tensor, stats=None) -> torch.Tensor:
    """hr' = (hr - mu_hr) / (std_hr + 1e-8) * std_ref + mu_ref, per channel.
    stats: (mu_hr, std_hr, mu_ref, std_ref), each (N, 1, 1, C) float32,
    where the caller computed them over whole frames of which hr and
    ref_lr are parts (the width-sharded steps, parallel/sharded.py);
    None computes them from hr and ref_lr."""
    if stats is None:
        stats = (*_chan_stats(hr), *_chan_stats(ref_lr))
    hr_mean, hr_std, ref_mean, ref_std = stats
    out = (hr.float() - hr_mean) / (hr_std + 1e-8)
    return (out * ref_std + ref_mean).to(hr.dtype)


def local_color_match(
    hr: torch.Tensor,
    ref_lr: torch.Tensor,
    match_factor: int = 8,
    blur_kernel_size: int = 17,
    blur_sigma: float = 8.0,
    full_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Subtract the low-frequency color drift of `hr` relative to `ref_lr`
    (area-down by match_factor, gaussian blur, bilinear-up difference).
    Identity when the pyramid would be smaller than the blur support.
    full_hw: the HR size of the whole frame when hr is a band of its
    columns (the width-sharded steps), which decides the identity test."""
    h, w = hr.shape[-3], hr.shape[-2]
    fh, fw = full_hw or (h, w)
    if not (fh // match_factor > blur_kernel_size // 2 and fh > 64 and fw > 64):
        return hr
    small = (h // match_factor, w // match_factor)
    lr_small = resize(ref_lr, small, "area")
    hr_small = resize(hr, small, "area")
    lr_blur = blur(lr_small, blur_kernel_size, blur_sigma)
    hr_blur = blur(hr_small, blur_kernel_size, blur_sigma)
    diff = resize(hr_blur - lr_blur, (h, w), "bilinear")
    return (hr.float() - diff.float()).to(hr.dtype)


def to_float(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0,255] -> float [0,1]."""
    return x.to(dtype) / 255.0


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8, with clamp; the cast truncates, like torch's
    `.to(torch.uint8)` after `*255` in the reference."""
    return (torch.clamp(x.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def to_yuv420(x: torch.Tensor) -> torch.Tensor:
    """float RGB [0,1] (N, H, W, 3) -> planar yuv420p uint8 (N, H*3//2, W),
    BT.601 limited range with 2x2-mean chroma.  Rows [0, H) = Y;
    [H, H+H//4) = U ((H/2, W/2) raveled W-wide); [H+H//4, H*3//2) = V.
    Requires H % 4 == 0 and W % 2 == 0."""
    n, h, w, _ = x.shape
    if h % 4 or w % 2:
        raise ValueError(f"yuv420p needs H % 4 == 0 and W % 2 == 0, got {(h, w)}")
    rgb = torch.clamp(x.float(), 0.0, 1.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + 65.481 * r + 128.553 * g + 24.966 * b
    rgb2 = rgb.reshape(n, h // 2, 2, w // 2, 2, 3).mean(dim=(2, 4))
    r2, g2, b2 = rgb2[..., 0], rgb2[..., 1], rgb2[..., 2]
    u = 128.0 - 37.797 * r2 - 74.203 * g2 + 112.0 * b2
    v = 128.0 + 112.0 * r2 - 93.786 * g2 - 18.214 * b2

    def q(p):
        return torch.clamp(torch.round(p), 0.0, 255.0).to(torch.uint8)

    return torch.cat([q(y), q(u).reshape(n, h // 4, w), q(v).reshape(n, h // 4, w)], dim=1)
