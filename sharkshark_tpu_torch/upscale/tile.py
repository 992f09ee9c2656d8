"""Tiled upscaling for large images (counterpart of the JAX package's
upscale/tile.py, RealESRGANer's tile/tile_pad processing, reference
src/upscale/model/realesrgan/factory.py:94-96,159-169).

The image is cut into tile x tile pieces, each with tile_pad pixels of
context on every side (reflect padding at the image's borders, edge
padding where reflect cannot reach), the pieces run through the model as
one batch, and their centres are stitched back.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..ops import pad2d

__all__ = ["tile_upscale"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_upscale(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    sr_params: Any,
    img: torch.Tensor,
    *,
    scale: int = 4,
    tile: int = 256,
    tile_pad: int = 10,
) -> torch.Tensor:
    """img: (N, H, W, C) in [0, 1] -> (N, H*scale, W*scale, C).  An image
    that fits one tile runs whole, as RealESRGANer clamps every halo
    inside the image."""
    n, h, w, c = img.shape
    if h <= tile and w <= tile:
        return sr_apply(sr_params, img)
    hp, wp = _ceil_to(h, tile), _ceil_to(w, tile)
    ty, tx = hp // tile, wp // tile
    pad = tile_pad
    # (left, right, top, bottom); reflect needs each pad below the size
    pads = (pad, wp - w + pad, pad, hp - h + pad)
    mode = "replicate" if max(pads[2:]) >= h or max(pads[:2]) >= w else "reflect"
    x = pad2d(img, pads, mode)

    t_in = tile + 2 * pad
    batch = torch.cat([
        x[:, iy * tile : iy * tile + t_in, ix * tile : ix * tile + t_in, :]
        for iy in range(ty) for ix in range(tx)
    ])  # (ty*tx*N, t_in, t_in, C), tile-major as the JAX package stacks them

    out = sr_apply(sr_params, batch.contiguous())
    s = scale
    core = out[:, pad * s : (pad + tile) * s, pad * s : (pad + tile) * s, :]
    core = core.reshape(ty, tx, n, tile * s, tile * s, c)
    core = core.permute(2, 0, 3, 1, 4, 5).reshape(n, hp * s, wp * s, c)
    return core[:, : h * s, : w * s, :]
