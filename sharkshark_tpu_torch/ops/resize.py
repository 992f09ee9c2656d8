"""Separable image resize on NHWC tensors, matching the JAX package's
`resize` (and through it torch `F.interpolate`, align_corners=False).

Modes: `area` (pre-downscale to the LR ladder), `bilinear` (local color
match upsample), `bicubic` (a=-0.75, final HR resize) and `nearest`.
Each is a 1-D resampler with a small fixed tap table built in numpy,
applied along H then W as K index_selects and K multiply-adds in float32;
integer-factor area downscale is a reshape + mean.  Same-size input is
returned unchanged.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize"]


@lru_cache(maxsize=None)
def _area_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Adaptive-average-pool taps: row i averages input range
    [floor(i*in/out), ceil((i+1)*in/out))."""
    starts = (np.arange(out_size) * in_size) // out_size
    ends = -((-(np.arange(out_size) + 1) * in_size) // out_size)  # ceil
    k = int((ends - starts).max())
    idx = starts[:, None] + np.arange(k)[None, :]
    w = np.where(idx < ends[:, None], 1.0, 0.0) / (ends - starts)[:, None]
    idx = np.minimum(idx, in_size - 1)
    return idx.astype(np.int64), w.astype(np.float32)


@lru_cache(maxsize=None)
def _linear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear (align_corners=False): source coord (i+0.5)*in/out - 0.5,
    clamped; two taps."""
    scale = in_size / out_size
    src = np.maximum((np.arange(out_size) + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    idx = np.stack([i0, i1], axis=1)
    w = np.stack([1.0 - frac, frac], axis=1)
    return idx.astype(np.int64), w.astype(np.float32)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    w1 = (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0
    w2 = a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a
    return np.where(at <= 1.0, w1, np.where(at < 2.0, w2, 0.0))


@lru_cache(maxsize=None)
def _cubic_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Bicubic (align_corners=False, a=-0.75), border indices clamped
    (duplicated clamped taps accumulate)."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    ks = np.arange(-1, 3)
    idx = np.clip(i0[:, None] + ks[None, :], 0, in_size - 1)
    w = _cubic_kernel(ks[None, :] - frac[:, None])
    return idx.astype(np.int64), w.astype(np.float32)


@lru_cache(maxsize=None)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Legacy torch 'nearest': src = floor(i * in / out)."""
    idx = (np.arange(out_size) * in_size) // out_size
    return np.minimum(idx, in_size - 1).astype(np.int64)


_TAPS = {"area": _area_taps, "bilinear": _linear_taps, "bicubic": _cubic_taps}


def _apply_axis(x: torch.Tensor, taps: tuple[np.ndarray, np.ndarray], axis: int) -> torch.Tensor:
    """out[..., o, ...] = sum_k w[o, k] * x[..., idx[o, k], ...] along
    `axis`, in float32."""
    idx, w = taps
    xf = x.float()
    shape = (-1,) + (1,) * (x.ndim - 1 - axis)
    out = None
    for k in range(idx.shape[1]):
        tap = xf.index_select(axis, torch.from_numpy(idx[:, k]).to(x.device))
        wk = torch.from_numpy(w[:, k]).to(x.device).reshape(shape)
        out = tap * wk if out is None else out + tap * wk
    return out


def resize(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize NHWC (any rank >= 3 with H, W as the trailing spatial dims
    before channels) to `size=(out_h, out_w)`.  Computation runs in
    float32 and is cast back to the input dtype."""
    out_h, out_w = int(size[0]), int(size[1])
    h_axis = x.ndim - 3
    w_axis = x.ndim - 2
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    orig_dtype = x.dtype

    if (in_h, in_w) == (out_h, out_w):
        return x

    if method == "nearest":
        out = x.index_select(h_axis, torch.from_numpy(_nearest_index(in_h, out_h)).to(x.device))
        return out.index_select(w_axis, torch.from_numpy(_nearest_index(in_w, out_w)).to(x.device))

    if method == "area" and in_h % out_h == 0 and in_w % out_w == 0:
        fh, fw = in_h // out_h, in_w // out_w
        lead = x.shape[:h_axis]
        xr = x.float().reshape(*lead, out_h, fh, out_w, fw, x.shape[-1])
        return xr.mean(dim=(h_axis + 1, h_axis + 3)).to(orig_dtype)

    try:
        builder = _TAPS[method]
    except KeyError:
        raise ValueError(f"unknown resize method: {method!r}") from None

    out = _apply_axis(x, builder(in_h, out_h), h_axis)
    if orig_dtype.is_floating_point and orig_dtype.itemsize < 4:
        # low-precision inputs keep the intermediate between the H and W
        # passes narrow too, as the JAX package does
        out = out.to(orig_dtype)
    out = _apply_axis(out, builder(in_w, out_w), w_axis)
    return out.to(orig_dtype)
