"""Fused model epilogue: pixel-shuffle(4) composed with a bicubic
downscale, by 2, 3 or 4 or by any rational factor num/den, computed at
LR resolution so the 4x image is never materialized (counterpart of the
JAX package's ops/fused_epilogue.py).

The integer ratios: at d=2 output pixel 2m mixes the shuffle phases
(3 of block m-1, 0, 1, 2 of block m) and 2m+1 the phases (1, 2, 3 of
block m, 0 of block m+1) with the bicubic taps K at frac 0.5; at d=3
non-antialiased bicubic samples the 4x image at 3o+1 with weights
(0, 1, 0, 0), a strided slice of one phase; at d=4 every tap falls in
one block, a channel mix with K.  Like the JAX functions, d=2 and d=4
compute in float32 for a bf16 input (its K is a float32 array).

Both steps are linear, so output pixel o along an axis is a fixed mix of
at most four (block, shuffle phase) taps, with a pattern that repeats
every P output pixels.  Borders use edge-replicated blocks, which
differs from clamped-index bicubic by at most one block at the edge (the
JAX package's documented fast-path deviation, kept here so the two agree;
the interior is exact to float rounding).  Plain torch ops: strided
slices and multiply-adds.
"""

from __future__ import annotations

from fractions import Fraction
from math import floor, gcd

import numpy as np
import torch

__all__ = [
    "K", "ps4_bicubic_down2", "nearest4_bicubic_down2", "ps4_bicubic_down3", "nearest4_bicubic_down3",
    "ps4_bicubic_down4", "nearest4_bicubic_down4", "ps4_bicubic_down_rational", "nearest4_bicubic_down_rational",
]

# bicubic 2x-downscale taps at frac 0.5 (a = -0.75)
K = np.array([-0.09375, 0.59375, 0.59375, -0.09375], np.float32)


def _shift(x: torch.Tensor, axis: int, by: int) -> torch.Tensor:
    """x[i - 1] (by = -1) or x[i + 1] (by = 1) along `axis`, with edge
    replication."""
    n = x.shape[axis]
    if by < 0:
        return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)


def _interleave(parts: list[torch.Tensor], axis: int) -> torch.Tensor:
    """out[..., len(parts) * i + q, ...] = parts[q][..., i, ...]."""
    stacked = torch.stack(parts, dim=axis + 1)
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return stacked.reshape(shape)


def _mix2_axis(y: torch.Tensor, axis: int, phase_axis: int) -> torch.Tensor:
    """y with blocks on `axis` and 4 shuffle phases on `phase_axis`
    (> axis) -> twice the blocks on `axis`, the phase axis consumed."""
    p0, p1, p2, p3 = (y.select(phase_axis, p) for p in range(4))
    k0, k1, k2, k3 = (float(k) for k in K)
    q0 = k0 * _shift(p3, axis, -1) + k1 * p0 + k2 * p1 + k3 * p2
    q1 = k0 * p1 + k1 * p2 + k2 * p3 + k3 * _shift(p0, axis, 1)
    return _interleave([q0, q1], axis)


def _float32_or_wider(y: torch.Tensor) -> torch.Tensor:
    return y.to(torch.promote_types(y.dtype, torch.float32))


def ps4_bicubic_down2(y: torch.Tensor) -> torch.Tensor:
    """y: (N, h, w, c*16) pre-shuffle tail activations (torch PixelShuffle
    channel order (c*4 + dy)*4 + dx) -> (N, 2h, 2w, c), equal to
    bicubic-2x-down(pixel_shuffle(y, 4)) except the 1-px border."""
    n, h, w, c16 = y.shape
    y6 = _float32_or_wider(y).reshape(n, h, w, c16 // 16, 4, 4)
    return _mix2_axis(_mix2_axis(y6, 1, 4), 2, 4)


def nearest4_bicubic_down2(x: torch.Tensor) -> torch.Tensor:
    """x: (N, h, w, c) -> (N, 2h, 2w, c), equal to
    bicubic-2x-down(nearest-4x-up(x)) except the 1-px border: the phases
    are all x, so out[2m] = k0 x[m-1] + (k1+k2+k3) x[m] and
    out[2m+1] = (k0+k1+k2) x[m] + k3 x[m+1]."""
    a, b = float(K[0]), float(K[1] + K[2] + K[3])
    c, d = float(K[0] + K[1] + K[2]), float(K[3])

    def mix(z, axis):
        return _interleave([a * _shift(z, axis, -1) + b * z, c * z + d * _shift(z, axis, 1)], axis)

    return mix(mix(x, 1), 2)


def _pick3_axis(z: torch.Tensor, axis: int, phase_axis: int | None, out_size: int) -> torch.Tensor:
    """Sample positions 3o+1 of the 4x image along `axis`: output
    o = 4m + q is block 3m + (3q+1)//4 at phase (3q+1) % 4 (the phase
    axis consumed; None when z has none, as for the nearest residual)."""
    parts = []
    for q in range(4):
        zq = z if phase_axis is None else z.select(phase_axis, (3 * q + 1) % 4)
        off = (3 * q + 1) // 4
        idx = [slice(None)] * zq.ndim
        idx[axis] = slice(off, off + 3 * (out_size // 4), 3)
        parts.append(zq[tuple(idx)])
    return _interleave(parts, axis)


def ps4_bicubic_down3(y: torch.Tensor) -> torch.Tensor:
    """y: (N, h, w, c*16) pre-shuffle -> (N, 4h/3, 4w/3, c), equal to
    bicubic-3x-down(pixel_shuffle(y, 4)), a pure subsample.  h and w must
    be multiples of 3."""
    n, h, w, c16 = y.shape
    assert h % 3 == 0 and w % 3 == 0, (h, w)
    y6 = y.reshape(n, h, w, c16 // 16, 4, 4)
    return _pick3_axis(_pick3_axis(y6, 1, 4, 4 * h // 3), 2, 4, 4 * w // 3)


def nearest4_bicubic_down3(x: torch.Tensor) -> torch.Tensor:
    """bicubic-3x-down(nearest-4x-up(x)) = x[(3o+1)//4] along each axis.
    H and W must be multiples of 3."""
    n, h, w, c = x.shape
    assert h % 3 == 0 and w % 3 == 0, (h, w)
    return _pick3_axis(_pick3_axis(x, 1, None, 4 * h // 3), 2, None, 4 * w // 3)


def ps4_bicubic_down4(y: torch.Tensor) -> torch.Tensor:
    """y: (N, h, w, c*16) pre-shuffle -> (N, h, w, c), equal to
    bicubic-4x-down(pixel_shuffle(y, 4)): src = 4o + 1.5, all four taps
    inside block o, a per-axis channel mix with the d=2 weights."""
    n, h, w, c16 = y.shape
    y6 = _float32_or_wider(y).reshape(n, h, w, c16 // 16, 4, 4)

    def mix(z, axis):
        return sum(float(k) * z.select(axis, p) for p, k in enumerate(K))

    return mix(mix(y6, 4), 4)


def nearest4_bicubic_down4(x: torch.Tensor) -> torch.Tensor:
    """bicubic-4x-down(nearest-4x-up(x)) == x exactly (all taps hit the
    same source pixel and the kernel sums to 1)."""
    return x


def _cubic_w(t: float, a: float = -0.75) -> float:
    at = abs(t)
    if at <= 1.0:
        return (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0
    if at < 2.0:
        return a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a
    return 0.0


def _rational_plan(num: int, den: int):
    """Tap plan for bicubic downscale by f = num/den composed with ps4.

    Returns (P, stride_blocks, classes) where classes[c] is a list of
    (block_offset, phase, weight) for output indices o = c (mod P).
    Output pixel o samples src = f*o + (f-1)/2 with 4 cubic taps."""
    f = Fraction(num, den)
    P = 4 * den // gcd(num, 4 * den)  # smallest P with f*P divisible by 4
    fp = f * P
    if fp % 4:
        raise ValueError(f"no tap plan for {num}/{den}")
    stride_blocks = int(fp) // 4
    classes = []
    for c in range(P):
        src = f * c + (f - 1) / 2
        i0 = floor(src)
        frac = float(src - i0)
        taps = []
        for t in range(-1, 3):
            wgt = _cubic_w(t - frac)
            if wgt == 0.0:
                continue
            pos = i0 + t
            taps.append((pos // 4, pos % 4, wgt))
        classes.append(taps)
    return P, stride_blocks, classes


def _edge_pad_axis(z: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    if lo == 0 and hi == 0:
        return z
    n = z.shape[axis]
    parts = [z.narrow(axis, 0, 1)] * lo + [z] + [z.narrow(axis, n - 1, 1)] * hi
    return torch.cat(parts, dim=axis)


def _apply_rational_axis(z, axis, phase_axis, out_size, plan):
    """z: blocks on `axis`, 4 shuffle phases on `phase_axis` (or None for
    the nearest-residual case where z has no phase axis)."""
    P, stride, classes = plan
    if out_size % P:
        raise ValueError(f"output size {out_size} is not a multiple of the tap period {P}")
    n_u = out_size // P
    offs = [b for taps in classes for (b, _, _) in taps]
    pad_l = max(0, -min(offs))
    max_need = max(offs) + stride * (n_u - 1)
    pad_r = max(0, max_need - (z.shape[axis] - 1))
    zp = _edge_pad_axis(z, axis, pad_l, pad_r)

    outs = []
    for taps in classes:
        acc = None
        for boff, ph, wgt in taps:
            src = zp if phase_axis is None else zp.select(phase_axis, ph)
            start = boff + pad_l
            idx = [slice(None)] * src.ndim
            idx[axis] = slice(start, start + stride * n_u, stride)
            term = src[tuple(idx)] * wgt
            acc = term if acc is None else acc + term
        outs.append(acc)
    stacked = torch.stack(outs, dim=axis + 1)  # (..., n_u, P, ...)
    shape = list(outs[0].shape)
    shape[axis] = out_size
    return stacked.reshape(shape)


def ps4_bicubic_down_rational(y: torch.Tensor, num: int, den: int) -> torch.Tensor:
    """y: (N, h, w, c*16) pre-shuffle -> bicubic-(num/den)-downscale of
    pixel_shuffle(y, 4): output (N, 4h*den/num, 4w*den/num, c)."""
    n, h, w, c16 = y.shape
    c = c16 // 16
    oh, ow = 4 * h * den // num, 4 * w * den // num
    if oh * num != 4 * h * den or ow * num != 4 * w * den:
        raise ValueError(f"{(h, w)} does not scale by 4*{den}/{num} to whole pixels")
    plan = _rational_plan(num, den)
    y6 = y.reshape(n, h, w, c, 4, 4)
    z = _apply_rational_axis(y6, 1, 4, oh, plan)  # consume dy
    return _apply_rational_axis(z, 2, 4, ow, plan)  # consume dx


def nearest4_bicubic_down_rational(x: torch.Tensor, num: int, den: int) -> torch.Tensor:
    """bicubic-(num/den)-down(nearest-4x-up(x)) via the same tap plan: the
    nearest image's value at hr position 4b+p is x[b], so phases collapse
    and taps hitting the same block merge."""
    n, h, w, c = x.shape
    oh, ow = 4 * h * den // num, 4 * w * den // num
    P, stride, classes = _rational_plan(num, den)
    merged = []
    for taps in classes:
        acc: dict[int, float] = {}
        for boff, _ph, wgt in taps:
            acc[boff] = acc.get(boff, 0.0) + wgt
        merged.append([(b, 0, wgt) for b, wgt in sorted(acc.items())])
    mplan = (P, stride, merged)
    z = _apply_rational_axis(x, 1, None, oh, mplan)
    return _apply_rational_axis(z, 2, None, ow, mplan)
