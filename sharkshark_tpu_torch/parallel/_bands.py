"""The width bands of the sharded steps, and moving tensors and state
between a whole frame and its bands.

A band is one device's share of a frame's width in LR columns: it owns
the centre [c0, c1) and computes [lo, hi), the centre with a halo of up
to R columns on each side, clipped at the frame's edges.  The centres
tile the frame; their edges are multiples of the step's alignment (the
frame's own width excepted), so every resize and every strided conv of
the step samples a band at the same positions as the whole frame.

A tensor tied to the frame's width (frames, outputs, state leaves)
holds a band's columns at its own scale: column x of the LR frame is
column x * leaf_w / base_w of a leaf, and the frame's end is the leaf's
end (the BSVD state pads the LR width to a multiple of 4).
"""

from __future__ import annotations

import contextlib
from fractions import Fraction
from math import ceil, gcd, lcm
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "Band", "ShardedState", "split_width", "alignment", "put", "put_each", "on_device", "tree_map", "replicate",
    "cols", "band_slice", "gather_bands", "gather_yuv420", "shared_stats", "shard_state", "gather_state",
]


class Band(NamedTuple):
    device: torch.device
    lo: int
    c0: int
    c1: int
    hi: int


def alignment(base: int, constraints) -> int:
    """The smallest multiple A of `base` such that A * r is a multiple of
    m for each (r, m) in constraints (r a ratio of widths, as a Fraction
    or an int)."""
    a = base
    for r, m in constraints:
        r = Fraction(r)
        q = m * r.denominator
        a = lcm(a, q // gcd(r.numerator, q))
    return a


def split_width(width: int, devices: list[torch.device], align: int, halo: int | None) -> list[Band]:
    """Bands over `width` LR columns, one a device in order, with centres
    of whole multiples of `align` (as even as they go; a device left
    without a whole unit gets no band) and halos of `halo` columns
    rounded up to `align` (None: the whole frame)."""
    units = ceil(width / align)
    base, extra = divmod(units, len(devices))
    h = width if halo is None else ceil(halo / align) * align
    bands, u0 = [], 0
    for k, dev in enumerate(devices):
        u = base + (k < extra)
        if u == 0:
            continue
        c0, c1 = u0 * align, min(width, (u0 + u) * align)
        u0 += u
        bands.append(Band(torch.device(dev), max(0, c0 - h), c0, c1, min(width, c1 + h)))
    return bands


def cols(x: int, frame_w: int, base_w: int, full_w: int) -> int:
    """LR column x at the scale of a tensor `full_w` wide whose columns
    span base_w LR columns (the frame's end maps to the tensor's end)."""
    if x == frame_w:
        return full_w
    v = Fraction(x * full_w, base_w)
    if v.denominator != 1:
        raise ValueError(f"column {x} of {frame_w} does not fall on a whole column of a {full_w}-wide tensor")
    return int(v)


def band_slice(band: Band, frame_w: int, base_w: int, full_w: int, centre: bool = False) -> slice:
    """A band's columns, [lo, hi) or its centre in the band's own tensor,
    at the scale of a whole tensor full_w wide."""
    lo = cols(band.lo, frame_w, base_w, full_w)
    if not centre:
        return slice(0, cols(band.hi, frame_w, base_w, full_w) - lo)
    return slice(cols(band.c0, frame_w, base_w, full_w) - lo, cols(band.c1, frame_w, base_w, full_w) - lo)


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device while a band's work is queued."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def put(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """x on `dev` without waiting: a host tensor goes through pinned
    memory and a non_blocking copy; a tensor already there is returned."""
    if x.device == dev:
        return x
    if dev.type == "cuda" and x.device.type == "cpu":
        return x.contiguous().pin_memory().to(dev, non_blocking=True)
    return x.to(dev, non_blocking=True)


def put_each(x: torch.Tensor, devices) -> dict:
    """x whole on each distinct device of `devices`, {device: tensor}: a
    host tensor is pinned once and uploaded once a device."""
    out, pinned = {}, None
    for dev in devices:
        if dev in out:
            continue
        if dev.type == "cuda" and x.device.type == "cpu":
            pinned = x.contiguous().pin_memory() if pinned is None else pinned
            out[dev] = pinned.to(dev, non_blocking=True)
        else:
            out[dev] = put(x, dev)
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts, tuples and lists (the state
    and parameter pytrees), with `rest` walked alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def replicate(params, devices) -> dict:
    """params on each distinct device, {device: params}."""
    reps = {}
    for dev in devices:
        if dev not in reps:
            reps[dev] = tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t, params)
    return reps


def gather_bands(parts: list[torch.Tensor], bands: list[Band], frame_w: int, full_w: int, axis: int,
                 dev: torch.device) -> torch.Tensor:
    """The whole tensor (full_w wide on `axis`) from the bands' parts:
    each part's centre, moved to `dev`, side by side."""
    pieces = []
    for part, band in zip(parts, bands):
        sl = band_slice(band, frame_w, frame_w, full_w, centre=True)
        pieces.append(put(part.narrow(axis, sl.start, sl.stop - sl.start), dev))
    return pieces[0] if len(pieces) == 1 and pieces[0].shape[axis] == full_w else torch.cat(pieces, dim=axis)


def gather_yuv420(parts: list[torch.Tensor], bands: list[Band], frame_w: int, full_w: int,
                  dev: torch.device) -> torch.Tensor:
    """The whole planar yuv420p frame (N, H*3//2, full_w) from the bands'
    (N, H*3//2, w): Y's columns, and U's and V's (H/2, w/2) planes, each
    gathered at its scale, then raveled full_w wide again
    (ops.to_yuv420's layout)."""
    n, rows, _ = parts[0].shape
    h = rows * 2 // 3

    def planes(p):
        w = p.shape[-1]
        return (p[:, :h], p[:, h : h + h // 4].reshape(n, h // 2, w // 2),
                p[:, h + h // 4 :].reshape(n, h // 2, w // 2))

    split = [planes(p) for p in parts]
    y = gather_bands([s[0] for s in split], bands, frame_w, full_w, 2, dev)
    u, v = (gather_bands([s[i] for s in split], bands, frame_w, full_w // 2, 2, dev) for i in (1, 2))
    return torch.cat([y, u.reshape(n, h // 4, full_w), v.reshape(n, h // 4, full_w)], dim=1)


def shared_stats(xs: list[torch.Tensor], dev: torch.device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-image per-channel mean and unbiased std over H x the union of
    the bands' columns (xs: each band's centre on its device), as
    ops.color._chan_stats computes them over the whole frame: the mean
    from the bands' sums, then the variance from their sums of squared
    deviations from that mean, each reduced on `dev`.  Returns (mean,
    std) on each band's device, (N, 1, 1, C) float32."""
    n = sum(x.shape[-3] * x.shape[-2] for x in xs)
    total = sum(put(x.float().sum(dim=(-3, -2), keepdim=True), dev) for x in xs)
    means = [put(total / n, x.device) for x in xs]
    ss = sum(put(((x.float() - m) ** 2).sum(dim=(-3, -2), keepdim=True), dev) for x, m in zip(xs, means))
    std = torch.sqrt(ss / max(n - 1, 1))
    return [(m, put(std, x.device)) for x, m in zip(xs, means)]


def _split_leaf(x, band: Band, frame_w: int, base_w: int):
    """A band's part of one whole-state leaf, as its own contiguous copy
    on the band's device; leaves without a width axis are copied whole."""
    if not torch.is_tensor(x):
        return x
    if x.ndim >= 3:
        ax = x.ndim - 2
        sl = band_slice(band, frame_w, base_w, x.shape[ax])
        lo = cols(band.lo, frame_w, base_w, x.shape[ax])
        x = x.narrow(ax, lo, sl.stop)
    y = put(x, band.device)
    return y.clone(memory_format=torch.contiguous_format) if y.device == x.device else y.contiguous()


class ShardedState:
    """A state pytree split over width bands: parts[k] is band k's state
    on its device.  Each leaf of 3 or more dims holds the band's columns
    [lo, hi) of the whole leaf on axis ndim-2 (parallel.width_sharding's
    axis), at the leaf's own scale; other leaves (the BSVD frame counter)
    are whole copies.  The centres are exact; `refresh()` makes the halo
    columns exact again from the neighbouring bands' centres."""

    def __init__(self, parts: list, bands: list[Band], frame_w: int, base_w: int, widths, plan=None) -> None:
        self.parts, self.bands, self.frame_w, self.base_w = parts, bands, frame_w, base_w
        self.widths = widths  # per leaf: the whole leaf's width, or None
        self._plan = plan  # refresh's copies, made at its first call

    def replace(self, parts: list) -> "ShardedState":
        return ShardedState(parts, self.bands, self.frame_w, self.base_w, self.widths, self._plan)

    def map(self, fn: Callable) -> "ShardedState":
        """fn applied to each band's state (one that keeps every column
        where it is, e.g. bsvd.ring_to_fifo_state)."""
        return self.replace([fn(p) for p in self.parts])

    def _copies(self) -> list[tuple]:
        """refresh's copies, (leaf, band to, band from, start in each, length)
        on the leaf's width axis; they depend on the bands and widths only."""
        plan = []
        for i, full_w in enumerate(_leaves(self.widths)):
            if full_w is None:
                continue
            for k, band in enumerate(self.bands):
                lo_k = cols(band.lo, self.frame_w, self.base_w, full_w)
                for j, src_band in enumerate(self.bands):
                    a, b = max(band.lo, src_band.c0), min(band.hi, src_band.c1)
                    if j == k or a >= b:
                        continue
                    a, b = (cols(v, self.frame_w, self.base_w, full_w) for v in (a, b))
                    lo_j = cols(src_band.lo, self.frame_w, self.base_w, full_w)
                    plan.append((i, k, j, a - lo_k, a - lo_j, b - a))
        return plan

    def refresh(self) -> None:
        """Write every band's halo columns, in every leaf, from the other
        bands' centres (a peer copy between cards, in place; one call for
        all of them)."""
        if self._plan is None:
            self._plan = self._copies()
        per_band = [_leaves(p) for p in self.parts]
        dsts, srcs = [], []
        for i, k, j, at_k, at_j, n in self._plan:
            dst = per_band[k][i]
            dsts.append(dst.narrow(dst.ndim - 2, at_k, n))
            srcs.append(per_band[j][i].narrow(dst.ndim - 2, at_j, n))
        if dsts:
            torch._foreach_copy_(dsts, srcs, non_blocking=True)

    def gather(self, dev: torch.device | None = None) -> Any:
        """The whole state on `dev` (default the first band's device)."""
        dev = dev or self.bands[0].device

        def leaf(full_w, *parts):
            if full_w is None:
                return put(parts[0], dev) if torch.is_tensor(parts[0]) else parts[0]
            ax = parts[0].ndim - 2
            pieces = []
            for part, band in zip(parts, self.bands):
                sl = band_slice(band, self.frame_w, self.base_w, full_w, centre=True)
                pieces.append(put(part.narrow(ax, sl.start, sl.stop - sl.start), dev))
            return torch.cat(pieces, dim=ax)

        return tree_map(leaf, self.widths, *self.parts)


def shard_state(state, bands: list[Band], frame_w: int, base_w: int) -> ShardedState:
    """Split a whole state (any device) over `bands`; base_w: the LR
    columns its width-scale-1 leaves span (the BSVD state's /4 width)."""
    widths = tree_map(lambda x: x.shape[x.ndim - 2] if torch.is_tensor(x) and x.ndim >= 3 else None, state)
    parts = [tree_map(lambda x: _split_leaf(x, band, frame_w, base_w), state) for band in bands]
    return ShardedState(parts, bands, frame_w, base_w, widths)


def gather_state(state, dev: torch.device | None = None):
    """The whole state of a ShardedState (any other state as it is)."""
    return state.gather(dev) if isinstance(state, ShardedState) else state
