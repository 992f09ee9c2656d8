"""Separable image resize on NHWC tensors, matching the JAX package's
`resize` (and through it torch `F.interpolate`, align_corners=False).

Modes: `area` (pre-downscale to the LR ladder), `bilinear` (local color
match upsample, EGVSR's flow upsample), `bicubic` (a=-0.75, final HR
resize) and `nearest`.  `upsample_tecogan` is the TecoGAN bicubic sX
upsample of EGVSR's BD flow.
Each is a 1-D resampler with a small fixed tap table built in numpy,
applied along H then W as K index_selects and K multiply-adds in float32;
integer-factor area downscale is a reshape + mean.  Same-size input is
returned unchanged.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.device import device_cache

__all__ = ["resize", "resize_nchw", "upsample_tecogan"]


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


@device_cache
def _device_taps(method: str, in_size: int, out_size: int, device: torch.device):
    """The tap table of `method` as tensors on `device`, one (index,
    weight) pair per tap."""
    idx, w = _TAPS[method](in_size, out_size)
    return tuple(
        (torch.from_numpy(idx[:, k].copy()).to(device), torch.from_numpy(w[:, k].copy()).to(device))
        for k in range(idx.shape[1])
    )


@device_cache
def _device_nearest(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nearest_index(in_size, out_size)).to(device)


def _apply_axis(x: torch.Tensor, method: str, out_size: int, axis: int) -> torch.Tensor:
    """out[..., o, ...] = sum_k w[o, k] * x[..., idx[o, k], ...] along
    `axis`, in float32."""
    xf = x.float()
    shape = (-1,) + (1,) * (x.ndim - 1 - axis)
    out = None
    for idx, w in _device_taps(method, x.shape[axis], out_size, x.device):
        tap = xf.index_select(axis, idx)
        wk = w.reshape(shape)
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
        out = x.index_select(h_axis, _device_nearest(in_h, out_h, x.device))
        return out.index_select(w_axis, _device_nearest(in_w, out_w, x.device))

    if method == "area" and in_h % out_h == 0 and in_w % out_w == 0:
        fh, fw = in_h // out_h, in_w // out_w
        lead = x.shape[:h_axis]
        xr = x.float().reshape(*lead, out_h, fh, out_w, fw, x.shape[-1])
        return xr.mean(dim=(h_axis + 1, h_axis + 3)).to(orig_dtype)

    if method not in _TAPS:
        raise ValueError(f"unknown resize method: {method!r}")

    out = _apply_axis(x, method, out_h, h_axis)
    if orig_dtype.is_floating_point and orig_dtype.itemsize < 4:
        # low-precision inputs keep the intermediate between the H and W
        # passes narrow too, as the JAX package does
        out = out.to(orig_dtype)
    out = _apply_axis(out, method, out_w, w_axis)
    return out.to(orig_dtype)


def resize_nchw(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """resize for NCHW layouts (channels before H, W)."""
    return torch.movedim(resize(torch.movedim(x, -3, -1), size, method), -1, -3)


@lru_cache(maxsize=None)
def _tecogan_kernels(s: int, a: float = -0.75) -> tuple:
    """Phase kernels of the TecoGAN bicubic upsampler: for output phase
    d (source offset d/s), 4 tap weights over [x-1, x, x+1, x+2]
    (reference net_utils.py:126-140, Eq.(6) of the Keys'81 paper)."""
    cubic = np.array(
        [
            [0, a, -2 * a, a],
            [1, 0, -(a + 3), a + 2],
            [0, -a, (2 * a + 3), -(a + 2)],
            [0, 0, a, -a],
        ],
        np.float64,
    )
    ks = [cubic @ np.array([1.0, d / s, (d / s) ** 2, (d / s) ** 3]) for d in range(s)]
    return tuple(tuple(float(v) for v in k) for k in ks)


def _tecogan_axis(x: torch.Tensor, k, s: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(-1, n + 2, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)  # replicate pad (1, 2)
    taps = [xp.narrow(axis, t, n) for t in range(4)]
    phases = []
    for d in range(s):
        # the same float32 sum order as the JAX package: ((w0 t0 + w1 t1) + w2 t2) + w3 t3
        acc = taps[0] * k[d][0]
        for t in range(1, 4):
            acc = acc + taps[t] * k[d][t]
        phases.append(acc)
    y = torch.stack(phases, dim=axis + 1)  # (..., n, s, ...)
    shape = list(x.shape)
    shape[axis] = n * s
    return y.reshape(shape)


def upsample_tecogan(x: torch.Tensor, s: int, a: float = -0.75) -> torch.Tensor:
    """TecoGAN-convention bicubic sX upsample: sampling phases d/s start AT
    each source pixel (not half-pixel centres like F.interpolate), 4 taps
    with replicate padding, bit-matching the reference's BicubicUpsample
    module (net_utils.py:111-166).  The production FRNet upsamples its
    optical flow with it (degradation='BD').  NHWC (any rank >= 3,
    trailing H, W, C); computed in float32, cast back to x's dtype."""
    k = _tecogan_kernels(s, a)
    xf = x.float()
    xf = _tecogan_axis(xf, k, s, x.ndim - 3)
    xf = _tecogan_axis(xf, k, s, x.ndim - 2)
    return xf.to(x.dtype)
