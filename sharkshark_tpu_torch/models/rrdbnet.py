"""RRDBNet, the RealESRGAN x4plus / x2plus / anime-6B generator
(counterpart of the JAX package's models/rrdbnet.py; the basicsr RRDBNet
the reference builds through its model zoo, reference
src/upscale/model/realesrgan/factory.py:112-127).

conv_first -> num_block x RRDB (3 residual dense blocks of 5 growing
convs, leaky 0.2, residual scale 0.2) -> conv_body (+ skip) -> 2 x
[nearest x2, conv, leaky] -> conv_hr, leaky -> conv_last; scale 2 folds
a pixel-unshuffle into the input.  The order of operations is the JAX
package's.  With autograd off, the leaky ReLUs and the residual scales
run in place and each tensor is dropped once its last conv has read it,
so at full width (720p, micro-batch 4) the peak is the x4 head's two
64-channel tensors at 2880x5120.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import conv2d, leaky_relu
from .torch_import import conv_from_torch, conv_to_torch, cpu_state_dict, to_tensors

__all__ = [
    "RRDBConfig", "X4PLUS", "X4PLUS_ANIME_6B", "X2PLUS", "init_params", "apply", "from_torch",
    "from_jax", "to_torch",
]


class RRDBConfig(NamedTuple):
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4


X4PLUS = RRDBConfig()
X4PLUS_ANIME_6B = RRDBConfig(num_block=6)
X2PLUS = RRDBConfig(scale=2)

_CONVS = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last")


def init_params(
    generator: torch.Generator, cfg: RRDBConfig = X4PLUS, device: str | torch.device = "cpu",
) -> dict:
    """He-normal weights drawn from `generator` (on the CPU, then moved to
    `device`), scaled by 0.1 inside the dense blocks as basicsr does;
    zero biases."""
    nf, gc = cfg.num_feat, cfg.num_grow_ch

    def conv(i, o, gain=1.0):
        w = torch.randn((3, 3, i, o), generator=generator) * (np.sqrt(2.0 / (9 * i)) * gain)
        return {"w": w, "b": torch.zeros(o)}

    def rdb():
        return {f"conv{k + 1}": conv(nf + k * gc, gc if k < 4 else nf, 0.1) for k in range(5)}

    in_ch = cfg.num_in_ch * (4 if cfg.scale == 2 else 1)
    params = {"body": [{f"rdb{j + 1}": rdb() for j in range(3)} for _ in range(cfg.num_block)]}
    for name, (i, o) in zip(_CONVS, [(in_ch, nf)] + [(nf, nf)] * 4 + [(nf, cfg.num_out_ch)]):
        params[name] = conv(i, o)
    return to_tensors(params, device)


def _conv(x: torch.Tensor, p: dict) -> torch.Tensor:
    return conv2d(x, p["w"], p.get("b"), padding=1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return leaky_relu(x, 0.2, inplace=not torch.is_grad_enabled())


def _residual(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y * 0.2 + x, the 0.2 rounded to y's dtype first and each step
    rounded once, as the JAX package computes it; in place on y (a conv's
    fresh output) when autograd is off."""
    s = torch.tensor(0.2, dtype=y.dtype).item()
    if torch.is_grad_enabled():
        return y * s + x
    return y.mul_(s).add_(x)


def _rdb_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    feats = [x]
    for k in range(1, 5):
        feats.append(_lrelu(_conv(torch.cat(feats, -1) if k > 1 else x, p[f"conv{k}"])))
    return _residual(_conv(torch.cat(feats, -1), p["conv5"]), x)


def _rrdb_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    out = _rdb_apply(p["rdb1"], x)
    out = _rdb_apply(p["rdb2"], out)
    out = _rdb_apply(p["rdb3"], out)
    return _residual(out, x)


def _pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC inverse pixel shuffle with torch's channel order (c_out =
    c * r * r, c major, then dy, dx)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, h // r, w // r, c * r * r)


def _nearest2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 of NHWC in one copy (each pixel repeated on a
    2x2 block, exactly the JAX package's nearest resize at x2)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def apply(params: dict, x: torch.Tensor, *, cfg: RRDBConfig = X4PLUS) -> torch.Tensor:
    """x: (N, H, W, in_ch) in [0, 1] -> (N, H*s, W*s, out_ch)."""
    if cfg.scale == 2:
        x = _pixel_unshuffle(x, 2)
    feat = _conv(x, params["conv_first"])
    body = feat
    for blk in params["body"]:
        body = _rrdb_apply(blk, body)
    body = _conv(body, params["conv_body"])
    feat = feat + body if torch.is_grad_enabled() else body.add_(feat)
    del body
    feat = _lrelu(_conv(_nearest2(feat), params["conv_up1"]))
    feat = _lrelu(_conv(_nearest2(feat), params["conv_up2"]))
    feat = _lrelu(_conv(feat, params["conv_hr"]))
    return _conv(feat, params["conv_last"])


def from_torch(
    sd: dict[str, np.ndarray], cfg: RRDBConfig = X4PLUS, device: str | torch.device = "cpu",
) -> dict:
    """basicsr's module names (body.{i}.rdb{j}.conv{k}, conv_first, ...)
    into the pytree."""
    params = {name: conv_from_torch(sd, f"{name}.") for name in _CONVS}
    params["body"] = [
        {f"rdb{j + 1}": {f"conv{k + 1}": conv_from_torch(sd, f"body.{i}.rdb{j + 1}.conv{k + 1}.")
                         for k in range(5)}
         for j in range(3)}
        for i in range(cfg.num_block)
    ]
    return to_tensors(params, device)


def to_torch(params: dict) -> dict[str, torch.Tensor]:
    """The inverse of from_torch: a CPU float32 state dict in basicsr's
    key layout."""
    sd = {}
    for name in _CONVS:
        sd.update(conv_to_torch(params[name], f"{name}."))
    for i, blk in enumerate(params["body"]):
        for rdb, convs in blk.items():
            for conv, p in convs.items():
                sd.update(conv_to_torch(p, f"body.{i}.{rdb}.{conv}."))
    return cpu_state_dict(sd)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's RRDBNet pytree (leaves as numpy arrays) as
    tensors; both packages store the convs HWIO."""
    return to_tensors(np_params, device)
