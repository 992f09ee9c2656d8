"""Plain PyTorch forward passes of the three networks, NCHW, from the
published checkpoints' key layouts.  No kernel, no cache, no batching
trick: every conv is `F.conv2d` on the layer's input.  Imports nothing
of the program.

- SRVGGNetCompact (Real-ESRGAN `realesr-general-x4v3`,
  github.com/xinntao/Real-ESRGAN, realesrgan/archs/srvgg_arch.py): conv +
  PReLU, num_conv more conv + PReLU, a conv to 3 * 16 channels, pixel
  shuffle x4, plus the nearest-upsampled input.
- BSVD (github.com/ChenyangQiQi/BSVD, bsvd/model.py): two U-Net
  DenBlocks whose memory convs are bidirectional temporal-shift convs.
  Written here as the published offline network over a clip (T, C, H,
  W): each shift conv reads, for frame g, channels [:C/8] of frame g+1,
  [C/8:C/4] of frame g-1 and the rest of frame g, with zero frames
  beyond the clip's ends.
- FRNet (EGVSR, github.com/Thmen/EGVSR, codes/models/networks/egvsr_nets.py):
  FNet's flow, the bilinear x4 flow upsample, the backward warp of the
  previous HR output (grid_sample, bilinear, border, align_corners),
  its space-to-depth, and SRNet.

`conv` is the one place a lower precision can be put in (the control,
quant.py): it takes a function applied to each conv's input and weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Nets", "load_state_dict", "srvgg", "bsvd_clip", "fnet", "srnet", "backward_warp",
           "space_to_depth", "sharpen", "global_color_match", "bicubic", "to_uint8"]


class Nets:
    """The weights, as float32 tensors on one device, and the function
    each conv's input and weight pass through (identity in float32)."""

    def __init__(self, sd: dict, device, quant=None) -> None:
        self.sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.quant = quant or (lambda t: t)

    def conv(self, x: torch.Tensor, prefix: str, stride: int = 1, padding: int = 1) -> torch.Tensor:
        w = self.sd[prefix + "weight"]
        b = self.sd.get(prefix + "bias")
        return F.conv2d(self.quant(x), self.quant(w), b, stride=stride, padding=padding)


def load_state_dict(path) -> dict:
    """A checkpoint's tensors: a plain state dict or one under
    'params_ema' / 'params' / 'state_dict' / 'model'."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("params_ema", "params", "state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
            break
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


# ------------------------------------------------------------- SRVGG


def srvgg(nets: Nets, x: torch.Tensor, num_conv: int = 32, upscale: int = 4) -> torch.Tensor:
    """x (N, 3, H, W) in [0, 1] -> (N, 3, H * upscale, W * upscale)."""
    y = x
    for i in range(num_conv + 1):
        y = F.prelu(nets.conv(y, f"body.{2 * i}."), nets.sd[f"body.{2 * i + 1}.weight"])
    y = F.pixel_shuffle(nets.conv(y, f"body.{2 * (num_conv + 1)}."), upscale)
    return y + F.interpolate(x, scale_factor=upscale, mode="nearest")


# -------------------------------------------------------------- BSVD


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The bidirectional temporal shift of a clip (T, C, H, W): channels
    [:C/8] from the next frame, [C/8:C/4] from the previous, zero beyond
    the clip."""
    fold = x.shape[1] // 8
    out = torch.zeros_like(x)
    out[:-1, :fold] = x[1:, :fold]
    out[1:, fold:2 * fold] = x[:-1, fold:2 * fold]
    out[:, 2 * fold:] = x[:, 2 * fold:]
    return out


def _denblock(nets: Nets, p: str, x: torch.Tensor) -> torch.Tensor:
    """One DenBlock over a clip (T, C, H, W); BSVD's key layout
    (base_model.nets_list.<i>.{inc,downc0,downc1,upc2,upc1,outc})."""
    a = _relu6

    def mem(prefix, v):
        v = a(nets.conv(_shift(v), prefix + "c1.net."))
        return a(nets.conv(_shift(v), prefix + "c2.net."))

    x0 = a(nets.conv(a(nets.conv(x, p + "inc.convblock.0.")), p + "inc.convblock.3."))
    x1 = mem(p + "downc0.convblock.3.", a(nets.conv(x0, p + "downc0.convblock.0.", stride=2)))
    x2 = mem(p + "downc1.convblock.3.", a(nets.conv(x1, p + "downc1.convblock.0.", stride=2)))
    u2 = F.pixel_shuffle(nets.conv(mem(p + "upc2.convblock.0.", x2), p + "upc2.convblock.1."), 2)
    u1 = F.pixel_shuffle(nets.conv(mem(p + "upc1.convblock.0.", u2 + x1), p + "upc1.convblock.1."), 2)
    y = nets.conv(a(nets.conv(u1 + x0, p + "outc.convblock.0.")), p + "outc.convblock.3.")
    return torch.cat([x[:, :3] - y[:, :3], y[:, 3:]], dim=1)


def bsvd_clip(nets: Nets, x: torch.Tensor) -> torch.Tensor:
    """BSVD over a clip: x (T, 4, H, W) (RGB + noise map, H and W
    multiples of 4) -> (T, 3, H, W)."""
    mid = _denblock(nets, "base_model.nets_list.0.", x)
    return _denblock(nets, "base_model.nets_list.1.", mid)


# ------------------------------------------------------------ FRNet


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def fnet(nets: Nets, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Optical flow x1 -> x2, (N, 2, H, W) in LR pixels (dx, dy)."""
    def block(v, name):
        v = _lrelu(nets.conv(v, f"fnet.{name}.0."))
        return _lrelu(nets.conv(v, f"fnet.{name}.2."))

    h, w = x1.shape[-2:]
    out = F.max_pool2d(block(torch.cat([x1, x2], dim=1), "encoder1"), 2)
    out = F.max_pool2d(block(out, "encoder2"), 2)
    out = F.max_pool2d(block(out, "encoder3"), 2)
    for name in ("decoder1", "decoder2", "decoder3"):
        out = F.interpolate(block(out, name), scale_factor=2, mode="bilinear", align_corners=False)
    out = _lrelu(nets.conv(out, "fnet.flow.0."))
    out = torch.tanh(nets.conv(out, "fnet.flow.2.")) * 24.0
    ph, pw = h - out.shape[-2], w - out.shape[-1]
    if ph or pw:
        out = F.pad(out, (0, pw, 0, ph), mode="reflect")
    return out


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W) sampled at (u + dx, v + dy): bilinear, border
    padding, align_corners=True."""
    n, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                            torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
    grid = torch.stack([gx + flow[:, 0] * (2.0 / (w - 1)), gy + flow[:, 1] * (2.0 / (h - 1))], dim=-1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """EGVSR's space-to-depth: output channel (dy * s + dx) * C + c."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, s * s * c, h // s, w // s)


def srnet(nets: Nets, lr: torch.Tensor, hr_prev_s2d: torch.Tensor, nb: int) -> torch.Tensor:
    """SRNet: (N, 3, H, W) and (N, 48, H, W) -> (N, 3, 4H, 4W)."""
    y = torch.relu(nets.conv(torch.cat([lr, hr_prev_s2d], dim=1), "srnet.conv_in.0."))
    for i in range(nb):
        r = torch.relu(nets.conv(y, f"srnet.resblocks.{i}.conv.0."))
        y = nets.conv(r, f"srnet.resblocks.{i}.conv.2.") + y
    return nets.conv(torch.relu(F.pixel_shuffle(y, 4)), "srnet.conv_out.")


# -------------------------------------------------- the post-processing


def sharpen(x: torch.Tensor, s: float) -> torch.Tensor:
    """The 3x3 sharpen stencil (9 at the centre, -1 around), blended with
    the identity by s and normalised to sum 1, reflect-padded:
    (1 + 8s) x - s * (sum of the 8 neighbours)."""
    k = torch.full((3, 3), -s, dtype=x.dtype, device=x.device)
    k[1, 1] = 1.0 + 8.0 * s
    c = x.shape[1]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp, k.expand(c, 1, 3, 3), groups=c)


def global_color_match(hr: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per image and channel: hr's mean and (unbiased) std moved to ref's."""
    mh, sh = hr.mean(dim=(2, 3), keepdim=True), hr.std(dim=(2, 3), keepdim=True)
    mr, sr = ref.mean(dim=(2, 3), keepdim=True), ref.std(dim=(2, 3), keepdim=True)
    return (hr - mh) / (sh + 1e-8) * sr + mr


def bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bicubic", align_corners=False)


def area(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.adaptive_avg_pool2d(x, size)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 by truncation, after a clamp."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
