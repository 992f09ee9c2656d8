"""SRVGGNetCompact, the production RealESRGAN upscaler core (counterpart
of the JAX package's models/srvgg.py).

A stack of 3x3 convs with PReLU, a (scale^2 * out_ch)-channel tail conv,
PixelShuffle, plus a nearest-upsampled residual of the input (reference
src/upscale/model/realesrgan/factory.py:18-82).  `realesr-general-x4v3`
(num_conv=32, num_feat=64) is the live pipeline's model.  Parameters are
a plain dict of tensors: {"convs": [{"w": HWIO, "b"}], "acts":
[{"alpha"}], "tail": {"w", "b"}}, the JAX package's pytree layout.

`conv_stack=L` (L >= 1) runs the body's 64 -> 64 conv + bias + PReLU
layers (convs[1:]) through K4 (ops/conv_stack.py), L layers a call (one
kernel launch a layer), the last group shorter; each layer then rounds
once, after its PReLU, where the layer-by-layer route rounds the conv,
the bias add and the PReLU each to the compute dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import conv2d, pixel_shuffle, prelu, resize
from ..ops import conv_stack as cs
from ..ops import fused_epilogue as fe
from .torch_import import conv_from_torch, prelu_from_torch, to_tensors

__all__ = [
    "SRVGGConfig", "GENERAL_X4V3", "init_params", "apply",
    "apply_down_rational", "from_torch", "from_jax", "check_conv_stack",
    "resolve_conv_stack", "DEFAULT_CONV_STACK",
]


class SRVGGConfig(NamedTuple):
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_conv: int = 32       # 32 = general-x4v3 (S), 16 = animevideov3 (XS)
    upscale: int = 4
    act_type: str = "prelu"  # 'relu' | 'prelu' | 'leakyrelu'


GENERAL_X4V3 = SRVGGConfig(num_conv=32)

# K4's layers a call on the body where the config allows it: of L = 1, 2,
# 4, L = 1 measured the fastest warm denoise step on an H100, and no
# slower than the layer-by-layer body (PERF.md)
DEFAULT_CONV_STACK = 1


def init_params(
    generator: torch.Generator,
    cfg: SRVGGConfig = GENERAL_X4V3,
    device: str | torch.device = "cpu",
) -> dict:
    """He-normal random weights drawn from `generator` (on the CPU, then
    moved to `device`)."""
    n_layers = cfg.num_conv + 1

    def conv(i, o):
        w = torch.randn((3, 3, i, o), generator=generator) * np.sqrt(2.0 / (i * 9))
        return {"w": w, "b": torch.zeros(o)}

    convs = [conv(cfg.num_in_ch, cfg.num_feat)]
    convs += [conv(cfg.num_feat, cfg.num_feat) for _ in range(1, n_layers)]
    tail = conv(cfg.num_feat, cfg.num_out_ch * cfg.upscale**2)
    acts = [{"alpha": torch.full((cfg.num_feat,), 0.25)} for _ in range(n_layers)]
    return to_tensors({"convs": convs, "acts": acts, "tail": tail}, device)


def _act(x: torch.Tensor, p: dict, act_type: str) -> torch.Tensor:
    if act_type == "prelu":
        return prelu(x, p["alpha"])
    if act_type == "relu":
        return torch.clamp(x, min=0)
    if act_type == "leakyrelu":
        return torch.where(x >= 0, x, x * 0.1)
    raise ValueError(act_type)


def check_conv_stack(cfg: SRVGGConfig, conv_stack: int) -> None:
    """Raise unless K4 can run this config's body `conv_stack` layers at a
    time (0 = the layer-by-layer route, always allowed)."""
    if conv_stack == 0:
        return
    if not 1 <= conv_stack <= cs.L_MAX:
        raise ValueError(f"conv_stack must be 0 or 1..{cs.L_MAX}, got {conv_stack}")
    if cfg.act_type != "prelu" or cfg.num_feat != cs.CHANNELS:
        raise ValueError(f"conv_stack needs act_type 'prelu' and num_feat {cs.CHANNELS}, got {cfg}")


def resolve_conv_stack(cfg: SRVGGConfig, conv_stack: int | None) -> int:
    """conv_stack as given (checked), or for None DEFAULT_CONV_STACK where
    K4 takes the config and 0 where it does not."""
    if conv_stack is None:
        k4 = cfg.act_type == "prelu" and cfg.num_feat == cs.CHANNELS
        return DEFAULT_CONV_STACK if k4 else 0
    check_conv_stack(cfg, conv_stack)
    return conv_stack


def _body(params: dict, x: torch.Tensor, cfg: SRVGGConfig, conv_stack: int = 0) -> torch.Tensor:
    check_conv_stack(cfg, conv_stack)
    convs, acts = params["convs"], params["acts"]
    n_direct = 1 if conv_stack else len(convs)
    y = x
    for conv_p, act_p in zip(convs[:n_direct], acts[:n_direct]):
        y = _act(conv2d(y, conv_p["w"], conv_p.get("b"), padding=1), act_p, cfg.act_type)
    for i in range(n_direct, len(convs), conv_stack or 1):
        group = range(i, min(i + conv_stack, len(convs)))
        alphas = torch.stack([acts[k]["alpha"] for k in group])
        # a conv without a bias (a checkpoint may omit it) adds zeros
        bias = torch.stack([convs[k].get("b", torch.zeros_like(alphas[0])) for k in group])
        y = cs.fused_conv_stack(y.contiguous(), torch.stack([convs[k]["w"] for k in group]), alphas, bias)
    return conv2d(y, params["tail"]["w"], params["tail"].get("b"), padding=1)


def apply(
    params: dict, x: torch.Tensor, *, cfg: SRVGGConfig = GENERAL_X4V3, conv_stack: int = 0,
) -> torch.Tensor:
    """x: (N, H, W, in_ch) in [0,1] -> (N, H*s, W*s, out_ch).  The nearest
    residual is added in pre-shuffle channel space (nearest_s(x) ==
    pixel_shuffle(repeat(x, s^2)) exactly), so one HR tensor is made.
    conv_stack: K4's layers a call for the body (0 = layer by layer)."""
    y = _body(params, x, cfg, conv_stack)
    if cfg.num_in_ch == cfg.num_out_ch:
        y = y + x.to(y.dtype).repeat_interleave(cfg.upscale**2, dim=-1)
        return pixel_shuffle(y, cfg.upscale)
    y = pixel_shuffle(y, cfg.upscale)
    h, w = x.shape[-3], x.shape[-2]
    return y + resize(x, (h * cfg.upscale, w * cfg.upscale), "nearest").to(y.dtype)


def apply_down_rational(
    params: dict, x: torch.Tensor, num: int, den: int, *,
    cfg: SRVGGConfig = GENERAL_X4V3, conv_stack: int = 0,
) -> torch.Tensor:
    """Fused epilogue: bicubic-(num/den)-downscale of apply(params, x)
    without making the 4x image (ops/fused_epilogue.py): exact in the
    interior, <=1-block edge-replicated borders.  conv_stack as apply."""
    if cfg.upscale != 4 or cfg.num_in_ch != cfg.num_out_ch:
        raise ValueError(f"the fused epilogue needs a 4x model with in_ch == out_ch, got {cfg}")
    y = _body(params, x, cfg, conv_stack)
    out = fe.ps4_bicubic_down_rational(y, num, den)
    return out + fe.nearest4_bicubic_down_rational(x, num, den).to(out.dtype)


def from_torch(
    sd: dict[str, np.ndarray],
    cfg: SRVGGConfig = GENERAL_X4V3,
    device: str | torch.device = "cpu",
) -> dict:
    """Reference module list: body.[conv,act]*(num_conv+1) + tail conv at
    body.{2*(num_conv+1)} (factory.py:42-69)."""
    n_layers = cfg.num_conv + 1
    convs = [conv_from_torch(sd, f"body.{2 * i}.") for i in range(n_layers)]
    acts = [
        prelu_from_torch(sd, f"body.{2 * i + 1}.") if cfg.act_type == "prelu" else {}
        for i in range(n_layers)
    ]
    tail = conv_from_torch(sd, f"body.{2 * n_layers}.")
    return to_tensors({"convs": convs, "acts": acts, "tail": tail}, device)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's SRVGG pytree (leaves as numpy arrays) as tensors."""
    return to_tensors(np_params, device)
