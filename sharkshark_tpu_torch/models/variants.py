"""Secondary VSR generators: ESPCN, VESPCN, SOF-VSR (counterpart of the
JAX package's models/variants.py; reference
models/networks/{espcn,vespcn,sofvsr}_nets.py, selected by the config's
`model.generator.name`).

Single-frame sub-pixel ESPCN, motion-compensated VESPCN (coarse-to-fine
flownet + STN warp) and SOF-VSR (a 3-level optical-flow RDB pyramid +
draft-cube SR).  Parameters are plain dicts of tensors in the JAX
package's pytree layout (convs HWIO), except ESPCN's deconv, which keeps
torch's own (I, O, kh, kw) layout unflipped (ops.conv_transpose2d).
Activations are NHWC.  The reference runs these on the Y channel
(in_nc=1); the channel count is a config knob.  The JAX package's
lane-folded ESPCN body (ops/lanefold.py) re-lays the same convs for the
TPU; here they are the plain convs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import backward_warp_ac0, conv2d, conv_transpose2d, leaky_relu, pixel_shuffle, resize
from ..ops.warp import _linspace, grid_sample_bilinear
from .torch_import import to_tensors

__all__ = [
    "ESPCNConfig", "espcn_init", "espcn_apply",
    "VESPCNConfig", "vespcn_init", "vespcn_apply",
    "SOFVSRConfig", "sofvsr_init", "sofvsr_apply",
    "from_jax",
]


def _conv(g: torch.Generator, kh: int, kw: int, i: int, o: int, bias: bool = True) -> dict:
    """He-normal HWIO weights (and a zero bias) drawn from `g`."""
    p = {"w": torch.randn((kh, kw, i, o), generator=g) * math.sqrt(2.0 / (i * kh * kw))}
    if bias:
        p["b"] = torch.zeros(o)
    return p


def _apply_conv(x: torch.Tensor, p: dict, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# ESPCN (reference espcn_nets.py:12-60)
# ---------------------------------------------------------------------------


class ESPCNConfig(NamedTuple):
    scale: int = 4
    in_nc: int = 1
    out_nc: int = 1
    up_method: str = "subconv"  # 'subconv' | 'reconv' | 'deconv'


def espcn_init(generator: torch.Generator, cfg: ESPCNConfig = ESPCNConfig(),
               device: str | torch.device = "cpu") -> dict:
    """Random weights drawn from `generator` (on the CPU, then moved to
    `device`).  pwconv has out_nc * scale^2 outputs (the reference hard-
    codes 1 * scale^2, a Y model; the JAX package generalises it)."""
    g = generator
    params = {
        "conv1": _conv(g, 5, 5, cfg.in_nc, 64),
        "conv2": _conv(g, 3, 3, 64, 32),
        "conv3": _conv(g, 3, 3, 32, 32),
        "pwconv": _conv(g, 1, 1, 32, cfg.out_nc * cfg.scale**2),
        "reconv": _conv(g, 1, 1, 32, cfg.out_nc),
        "deconv": {"w": torch.randn((32, cfg.out_nc, 5, 5), generator=g) * math.sqrt(2.0 / (32 * 25)),
                   "b": torch.zeros(cfg.out_nc)},
    }
    return to_tensors(params, device)


def espcn_apply(params: dict, x: torch.Tensor, *, cfg: ESPCNConfig = ESPCNConfig()) -> torch.Tensor:
    """x: (N, H, W, in_nc) -> sigmoid HR (N, sH, sW, out_nc)."""
    s = cfg.scale
    y = torch.tanh(_apply_conv(x, params["conv1"], padding=2))
    y = torch.tanh(_apply_conv(y, params["conv2"], padding=1))
    y = torch.tanh(_apply_conv(y, params["conv3"], padding=1))
    if cfg.up_method == "deconv":
        p = params["deconv"]
        y = conv_transpose2d(y, p["w"], p.get("b"), stride=s, padding=2, output_padding=s - 1)
    elif cfg.up_method == "reconv":
        h, w = y.shape[1], y.shape[2]
        y = _apply_conv(resize(y, (h * s, w * s), "bilinear"), params["reconv"])
    else:
        y = pixel_shuffle(_apply_conv(y, params["pwconv"]), s)
    return torch.sigmoid(y)


# ---------------------------------------------------------------------------
# VESPCN (reference vespcn_nets.py + utils/motion.py CoarseFineFlownet/STN)
# ---------------------------------------------------------------------------


class VESPCNConfig(NamedTuple):
    scale: int = 4
    channel: int = 1
    depth: int = 3


def _flownet_init(g: torch.Generator, channel: int) -> dict:
    return {
        "coarse": [
            _conv(g, 5, 5, channel * 2, 24),
            _conv(g, 3, 3, 24, 24),
            _conv(g, 5, 5, 24, 24),
            _conv(g, 3, 3, 24, 24),
            _conv(g, 3, 3, 24, 32),
        ],
        "fine": [
            _conv(g, 5, 5, channel * 3 + 2, 24),
            _conv(g, 3, 3, 24, 24),
            _conv(g, 3, 3, 24, 24),
            _conv(g, 3, 3, 24, 24),
            _conv(g, 3, 3, 24, 8),
        ],
    }


def _flownet_apply(p: dict, target: torch.Tensor, ref: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Coarse-to-fine flow from ref -> target (motion.py:139-178)."""
    c = p["coarse"]
    y = torch.cat([ref, target], dim=-1)
    y = torch.relu(_apply_conv(y, c[0], stride=2, padding=2))
    y = torch.relu(_apply_conv(y, c[1], padding=1))
    y = torch.relu(_apply_conv(y, c[2], stride=2, padding=2))
    y = torch.relu(_apply_conv(y, c[3], padding=1))
    y = torch.tanh(_apply_conv(y, c[4], padding=1))
    flow_c = pixel_shuffle(y, 4)  # (N, H, W, 2)
    wc = backward_warp_ac0(ref, flow_c)
    f = p["fine"]
    y = torch.cat([ref, target, flow_c, wc], dim=-1)
    y = torch.relu(_apply_conv(y, f[0], stride=2, padding=2))
    y = torch.relu(_apply_conv(y, f[1], padding=1))
    y = torch.relu(_apply_conv(y, f[2], padding=1))
    y = torch.relu(_apply_conv(y, f[3], padding=1))
    y = torch.tanh(_apply_conv(y, f[4], padding=1))
    flow_f = pixel_shuffle(y, 2) + flow_c
    return flow_f * gain


def vespcn_init(generator: torch.Generator, cfg: VESPCNConfig = VESPCNConfig(),
                device: str | torch.device = "cpu") -> dict:
    g, c = generator, cfg.channel
    params = {
        "mc": _flownet_init(g, c),
        "entry": _conv(g, 3, 3, c * cfg.depth, 64),
        "body": [[_conv(g, 3, 3, 64, 64), _conv(g, 3, 3, 64, 64)] for _ in range(3)],
        "conv": _conv(g, 3, 3, 64, 64 * cfg.scale**2),
        "exit": _conv(g, 3, 3, 64, c),
    }
    return to_tensors(params, device)


def vespcn_apply(params: dict, lr_seq: torch.Tensor, *, cfg: VESPCNConfig = VESPCNConfig()) -> torch.Tensor:
    """lr_seq: (T, H, W, C), a window of `depth` frames -> the HR centre
    frame (1, sH, sW, C) (reference VESPNet.forward, vespcn_nets.py:73-102)."""
    t = lr_seq.shape[0]
    if t != cfg.depth:
        raise ValueError(f"vespcn_apply: a window of {cfg.depth} frames, got {t}")
    center = cfg.depth // 2
    target = lr_seq[center : center + 1]
    warps = []
    for i in range(cfg.depth):
        if i == center:
            continue
        ref = lr_seq[i : i + 1]
        flow = _flownet_apply(params["mc"], target, ref, gain=32.0)
        warps.append(backward_warp_ac0(ref, flow))
    warps.append(target)
    x = torch.cat(warps, dim=-1)

    # SRNet (reference vespcn_nets.py:46-66)
    y = _apply_conv(x, params["entry"], padding=1)
    z = y
    for blk in params["body"]:
        r = torch.relu(z)
        r = torch.relu(_apply_conv(r, blk[0], padding=1))
        z = _apply_conv(r, blk[1], padding=1) + z
    z = torch.relu(z) + y
    z = pixel_shuffle(_apply_conv(z, params["conv"], padding=1), cfg.scale)
    return _apply_conv(z, params["exit"], padding=1)


# ---------------------------------------------------------------------------
# SOF-VSR (reference sofvsr_nets.py:20-210)
# ---------------------------------------------------------------------------


class SOFVSRConfig(NamedTuple):
    scale: int = 4
    n_dense_ofr: int = 4
    n_dense_sr: int = 5


def _rdb_init(g: torch.Generator, n_dense: int, channels: int, growth: int) -> dict:
    layers = []
    c = channels
    for _ in range(n_dense):
        layers.append(_conv(g, 3, 3, c, growth, bias=False))
        c += growth
    return {"dense": layers, "fuse": _conv(g, 1, 1, c, channels, bias=False)}


def _rdb_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x
    for layer in p["dense"]:
        out = leaky_relu(_apply_conv(y, layer, padding=1), 0.1)
        y = torch.cat([y, out], dim=-1)
    return _apply_conv(y, p["fuse"]) + x


def _ofr_level_init(g: torch.Generator, in_ch: int, out_ch: int) -> dict:
    return {
        "conv1": _conv(g, 3, 3, in_ch, 32, bias=False),
        "rdb1": _rdb_init(g, 4, 32, 32),
        "rdb2": _rdb_init(g, 4, 32, 32),
        "bottleneck": _conv(g, 3, 3, 64, out_ch, bias=False),
        "conv2": _conv(g, 3, 3, out_ch, out_ch),
    }


def _ofr_level_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = _apply_conv(x, p["conv1"], padding=1)
    b1 = _rdb_apply(p["rdb1"], y)
    b2 = _rdb_apply(p["rdb2"], b1)
    y = _apply_conv(torch.cat([b1, b2], dim=-1), p["bottleneck"], padding=1)
    return _apply_conv(y, p["conv2"], padding=1)


def sofvsr_init(generator: torch.Generator, cfg: SOFVSRConfig = SOFVSRConfig(),
                device: str | torch.device = "cpu") -> dict:
    g, s = generator, cfg.scale
    params = {
        "ofr_l1": _ofr_level_init(g, 2, 2),
        "ofr_l2": _ofr_level_init(g, 6, 2),
        "ofr_l3": _ofr_level_init(g, 6, 2 * s * s),
        "sr_conv": _conv(g, 3, 3, 3 + 2 * s * s, 64, bias=False),
        "sr_rdbs": [_rdb_init(g, 5, 64, 32) for _ in range(5)],
        "sr_bottleneck": _conv(g, 1, 1, 64 * 6, s * s, bias=False),
        "sr_conv2": _conv(g, 3, 3, s * s, s * s),
    }
    return to_tensors(params, device)


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _sof_flow_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Reference optical_flow_warp (sofvsr_nets.py:20-44): the base grid
    built with the align_corners=True normalisation, the flow added as
    flow * 31 / (size - 1) in normalised units, sampled with grid_sample's
    default align_corners=False and border padding.  The mismatch is part
    of the trained model's semantics, so it is kept, term for term as the
    JAX package computes it."""
    n, h, w, _ = image.shape
    iu = _linspace(w, image.device)[None, None, :]
    iv = _linspace(h, image.device)[None, :, None]
    gx = iu + flow[..., 0].float() * np.float32(31.0 / (w - 1))
    gy = iv + flow[..., 1].float() * np.float32(31.0 / (h - 1))
    # the align_corners=False sample coordinates in the ac=True sampler's frame
    px = (gx + 1.0) * (w / 2.0) - 0.5
    py = (gy + 1.0) * (h / 2.0) - 0.5
    g1x = px / ((w - 1.0) / 2.0) - 1.0
    g1y = py / ((h - 1.0) / 2.0) - 1.0
    return grid_sample_bilinear(image, torch.stack([g1x, g1y], dim=-1))


def _ofrnet_apply(params: dict, x: torch.Tensor, scale: int) -> torch.Tensor:
    """x: (N, H, W, 2) frame pair -> HR flow (N, sH, sW, 2)
    (reference OFRnet.forward, sofvsr_nets.py:107-147)."""
    # level 1: half resolution
    flow_l1 = _ofr_level_apply(params["ofr_l1"], _avgpool2(x))
    h, w = x.shape[1], x.shape[2]
    flow_l1_up = resize(flow_l1, (h, w), "bilinear")
    # level 2: full resolution
    warped = _sof_flow_warp(x[..., 0:1], flow_l1_up)
    res = x[..., 1:2] - warped
    flow_l2 = _ofr_level_apply(params["ofr_l2"], torch.cat([x, warped, res, flow_l1_up], dim=-1)) + flow_l1_up
    # level 3: HR flow
    warped2 = _sof_flow_warp(x[..., 0:1], flow_l2)
    res2 = x[..., 1:2] - warped2
    flow_l3 = _ofr_level_apply(params["ofr_l3"], torch.cat([x, warped2, res2, flow_l2], dim=-1))
    return pixel_shuffle(flow_l3, scale) + resize(flow_l2, (h * scale, w * scale), "bilinear")


def sofvsr_apply(params: dict, lr_seq: torch.Tensor, *, cfg: SOFVSRConfig = SOFVSRConfig()) -> torch.Tensor:
    """lr_seq: (N, H, W, 3) = (prev, cur, next) Y frames stacked in the
    channel dim -> HR centre (N, sH, sW, 1)
    (reference SOFNet.forward, sofvsr_nets.py:186-210)."""
    s = cfg.scale
    in01 = torch.stack([lr_seq[..., 0], lr_seq[..., 1]], dim=-1)
    in21 = torch.stack([lr_seq[..., 2], lr_seq[..., 1]], dim=-1)
    flow01 = _ofrnet_apply(params, in01, s)
    flow21 = _ofrnet_apply(params, in21, s)

    drafts = [lr_seq]
    for i in range(s):
        for j in range(s):
            drafts.append(_sof_flow_warp(lr_seq[..., 0:1], flow01[:, i::s, j::s, :] / s))
            drafts.append(_sof_flow_warp(lr_seq[..., 2:3], flow21[:, i::s, j::s, :] / s))
    cube = torch.cat(drafts, dim=-1)

    y = _apply_conv(cube, params["sr_conv"], padding=1)
    feats = [y]
    b = y
    for rdb in params["sr_rdbs"]:
        b = _rdb_apply(rdb, b)
        feats.append(b)
    out = _apply_conv(torch.cat(feats[1:] + [y], dim=-1), params["sr_bottleneck"])
    out = _apply_conv(out, params["sr_conv2"], padding=1)
    return pixel_shuffle(out, s)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """A JAX package variant pytree (leaves as numpy arrays) as tensors.
    ESPCN's deconv weight, stored flipped and HWIO there, goes back to
    (I, O, kh, kw) unflipped, as fsrcnn.from_jax does."""
    params = dict(np_params)
    if "deconv" in params:
        dw = np.asarray(np_params["deconv"]["w"])
        params["deconv"] = {**np_params["deconv"],
                            "w": np.ascontiguousarray(np.transpose(dw[::-1, ::-1], (2, 3, 0, 1)))}
    return to_tensors(params, device)
