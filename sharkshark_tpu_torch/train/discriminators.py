"""TecoGAN discriminators (counterpart of the JAX package's
train/discriminators.py; reference models/networks/tecogan_nets.py:
298-515).

DiscriminatorBlocks (4 x stride-2 conv + BatchNorm + LeakyReLU, /16),
the spatial D (optionally conditioned on the bicubic upsample) and the
spatio-temporal D (TecoGAN triplets: original | warped | bicubic
conditional, concatenated channelwise per 3-frame clip).

BatchNorm runs on batch statistics: the discriminators exist only inside
the GAN training step, where the reference keeps net_D.train() on, so no
running averages are carried.  The block convs pass no bias, as the JAX
package's do, though its init makes one: the leaf stays, so that the two
parameter trees match, and its gradient is None here (zero in JAX).

Layout is NHWC; the dense head flattens the NHWC features, in the JAX
package's order.  The `*_forward_sequence` functions return (logits,
features), and the spatio-temporal one the merged flow too, which the
fake pass reuses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.egvsr import fnet_apply
from ..models.torch_import import to_tensors
from ..ops import conv2d, leaky_relu, resize
from ..ops.warp import backward_warp

__all__ = [
    "DiscriminatorConfig",
    "init_spatial",
    "init_spatio_temporal",
    "spatial_forward",
    "spatio_temporal_forward",
    "spatial_forward_sequence",
    "spatio_temporal_forward_sequence",
    "from_jax",
]


class DiscriminatorConfig(NamedTuple):
    in_nc: int = 3
    spatial_size: int = 128
    tempo_range: int = 3
    scale: int = 4
    use_cond: bool = False  # spatial D's conditional input


def _conv_init(g: torch.Generator, kh: int, kw: int, i: int, o: int) -> dict:
    w = torch.randn((kh, kw, i, o), generator=g) * math.sqrt(2.0 / (i * kh * kw))
    return {"w": w, "b": torch.zeros(o)}


def _bn_init(c: int) -> dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_head(g: torch.Generator, in_ch: int, spatial_size: int, device) -> dict:
    feat = 256 * (spatial_size // 16) ** 2
    chans = [(64, 64), (64, 64), (64, 128), (128, 256)]
    params = {
        "conv_in": _conv_init(g, 3, 3, in_ch, 64),
        "body": {"blocks": [{"conv": _conv_init(g, 4, 4, ci, co), "bn": _bn_init(co)} for ci, co in chans]},
        "dense": {"w": torch.randn((feat, 1), generator=g) / math.sqrt(feat), "b": torch.zeros(1)},
    }
    return to_tensors(params, device)


def init_spatial(generator: torch.Generator, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 device: str | torch.device = "cpu") -> dict:
    """Seeded weights of the spatial D (the JAX package's scheme, drawn
    from `generator`)."""
    mult = 2 if cfg.use_cond else 1
    return _init_head(generator, cfg.in_nc * mult, cfg.spatial_size, device)


def init_spatio_temporal(generator: torch.Generator, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                         device: str | torch.device = "cpu") -> dict:
    """Seeded weights of the spatio-temporal D: its input is the
    conditional, the original and the warped triplet (x 3)."""
    return _init_head(generator, cfg.in_nc * cfg.tempo_range * 3, cfg.spatial_size, device)


def _batch_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics over N, H and W, the biased variance, as the JAX
    package writes it."""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _head_forward(p: dict, x: torch.Tensor) -> tuple[torch.Tensor, list]:
    y = leaky_relu(conv2d(x, p["conv_in"]["w"], p["conv_in"]["b"], padding=1), 0.2)
    feats = []
    for blk in p["body"]["blocks"]:
        y = conv2d(y, blk["conv"]["w"], None, stride=2, padding=1)
        y = leaky_relu(_batch_norm(y, blk["bn"]), 0.2)
        feats.append(y)
    y = y.reshape(y.shape[0], -1)  # NHWC order, as the dense weights read it
    return y @ p["dense"]["w"] + p["dense"]["b"], feats


spatial_forward = _head_forward
spatio_temporal_forward = _head_forward


def spatial_forward_sequence(params: dict, data: torch.Tensor, bi_data: torch.Tensor | None = None,
                             cfg: DiscriminatorConfig = DiscriminatorConfig()):
    """data: (N, T, H, W, C) -> logits (N*T, 1), feature list
    (reference tecogan_nets.py:494-515)."""
    n, t, h, w, c = data.shape
    x = data.reshape(n * t, h, w, c)
    if cfg.use_cond:
        if bi_data is None:
            raise ValueError("a conditional spatial D needs bi_data")
        x = torch.cat([bi_data.reshape(n * t, h, w, c), x], dim=-1)
    return _head_forward(params, x)


def _triplet_pack(x: torch.Tensor, n_clip: int, h: int, w: int, c: int) -> torch.Tensor:
    """(N, 3k, H, W, C) -> (n_clip, H, W, C*3) with TecoGAN's rrrgggbbb
    channel order (tecogan_nets.py:423-436)."""
    x = x.reshape(n_clip, 3, h, w, c)
    return x.permute(0, 2, 3, 4, 1).reshape(n_clip, h, w, c * 3)


def _merged_flow(lr_data, hr_flow, fnet_params, use_pp_crit: bool, n: int, t: int, h: int, w: int,
                 c: int, scale: int) -> torch.Tensor:
    """[backward, zero, forward] flow per 3-frame clip, (n_clip*3, H, W, 2),
    outside autograd (the JAX package's stop_gradient).  With the ping-pong
    sequence the forward flows are the reversed half's; otherwise FNet
    runs on the LR pairs and its flow is resized bilinearly x scale."""
    n_clip = n * t // 3
    with torch.no_grad():
        hr_flow_bw = hr_flow[:, 0:t:3]
        if use_pp_crit:
            hr_flow_fw = torch.flip(hr_flow, dims=(1,))[:, 1:t:3]
        else:
            if fnet_params is None:
                raise ValueError("without the ping-pong flows the spatio-temporal D needs fnet_params")
            lr_h, lr_w = lr_data.shape[2], lr_data.shape[3]
            lr_curr = lr_data[:, 1:t:3].reshape(n_clip, lr_h, lr_w, c)
            lr_next = lr_data[:, 2:t:3].reshape(n_clip, lr_h, lr_w, c)
            lr_flow_fw = fnet_apply(fnet_params, lr_curr, lr_next)
            hr_flow_fw = scale * resize(lr_flow_fw, (h, w), "bilinear")
            hr_flow_fw = hr_flow_fw.reshape(n, t // 3, h, w, 2)
        idle = torch.zeros_like(hr_flow_bw)
        return torch.stack([hr_flow_bw, idle, hr_flow_fw], dim=2).reshape(n_clip * 3, h, w, 2).detach()


def spatio_temporal_forward_sequence(
    params: dict,
    data: torch.Tensor,
    *,
    lr_data: torch.Tensor,
    bi_data: torch.Tensor,
    hr_flow: torch.Tensor,
    fnet_params: dict | None = None,
    use_pp_crit: bool = True,
    crop_border_ratio: float = 1.0,
    hr_flow_merge: torch.Tensor | None = None,
    cfg: DiscriminatorConfig = DiscriminatorConfig(),
):
    """TecoGAN spatio-temporal D on 3-frame clips (reference
    tecogan_nets.py:366-460).

    data: (N, T, H, W, C), the HR or GT sequence; hr_flow: (N, T-1, H, W,
    2).  Returns (logits (n_clip, 1), features, hr_flow_merge): the merged
    flow is returned for reuse on the fake pass, like the reference's
    ret_dict.  The warp is the plain gather backward_warp, which autograd
    runs through."""
    n, t, h, w, c = data.shape
    t = t // 3 * 3
    n_clip = n * t // 3
    if hr_flow_merge is None:
        hr_flow_merge = _merged_flow(lr_data, hr_flow, fnet_params, use_pp_crit, n, t, h, w, c, cfg.scale)

    cond_data = _triplet_pack(bi_data[:, :t], n_clip, h, w, c)
    orig_data = _triplet_pack(data[:, :t], n_clip, h, w, c)
    warp = backward_warp(data[:, :t].reshape(n * t, h, w, c), hr_flow_merge)
    warp_data = _triplet_pack(warp.reshape(n, t, h, w, c), n_clip, h, w, c)
    # crop the borders, then zero-pad back (training stability, :443-446)
    s_size = cfg.spatial_size
    c_size = int(s_size * crop_border_ratio)
    n_pad = (s_size - c_size) // 2
    if n_pad > 0:
        core = warp_data[:, n_pad : n_pad + c_size, n_pad : n_pad + c_size, :]
        warp_data = torch.nn.functional.pad(core, (0, 0, n_pad, n_pad, n_pad, n_pad))

    x = torch.cat([orig_data, warp_data, cond_data], dim=-1)
    logits, feats = _head_forward(params, x)
    return logits, feats, hr_flow_merge


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's discriminator pytree (leaves as numpy arrays) as
    tensors."""
    return to_tensors(np_params, device)
