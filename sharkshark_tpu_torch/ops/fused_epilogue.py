"""Fused model epilogue: pixel-shuffle(4) composed with a bicubic
downscale by any rational factor num/den, computed at LR resolution so
the 4x image is never materialized (counterpart of the JAX package's
ops/fused_epilogue.py).

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

import torch

__all__ = ["ps4_bicubic_down_rational", "nearest4_bicubic_down_rational"]


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
