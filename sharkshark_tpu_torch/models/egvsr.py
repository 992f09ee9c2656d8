"""EGVSR / FRNet, frame-recurrent video super-resolution (counterpart of
the JAX package's models/egvsr.py).

FNet (a 3-level conv encoder/decoder for optical flow, tanh * 24 maximum
velocity), SRNet (the low-resolution frame concatenated with the
space-to-depth of the warped previous HR frame -> residual blocks ->
folded conv_out -> PixelShuffle(4)), and the FRNet recurrence
flow -> upsampled flow -> backward warp of hr_prev -> SRNet (reference
src/upscale/model/egvsr/egvsr.py:12-265).  Parameters are a plain dict
of tensors in the JAX package's pytree layout (HWIO convs), activations
NHWC.

The HR warp goes through K3 (`ops.warp.backward_warp_fast`, the CUDA
kernel `csrc/backward_warp.cu` on a CUDA tensor), which writes the
space-to-depth layout SRNet consumes directly.  The scene-cut skip is
decided on the device and handed to the kernel as a flag, so a frame
never waits for the host; FNet then runs on cut frames too and its flow
goes unused.  The training unroll (`forward_sequence`) is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import conv2d, leaky_relu, max_pool2, pad2d, pixel_shuffle, resize, upsample_tecogan
from ..ops.warp import backward_warp_fast
from .torch_import import conv_from_torch, to_tensors

__all__ = [
    "EGVSRConfig", "DEFAULT", "PRODUCTION", "init_params", "fnet_apply", "srnet_apply",
    "frnet_step", "init_recurrent_state", "infer_step", "infer_chunk", "infer_sequence",
    "pad_sequence", "config_from_torch", "from_torch", "from_jax",
]


class EGVSRConfig(NamedTuple):
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 16
    scale: int = 4
    degradation: str = "BI"  # flow upsample: bilinear (BI); BD uses bicubic


DEFAULT = EGVSRConfig()
# the reference's production instantiation (egvsr_upscaler.py:26):
# FRNet(nb=10, degradation='BD'), with the TecoGAN bicubic flow upsample
PRODUCTION = EGVSRConfig(nb=10, degradation="BD")


def _upsample_flow(flow: torch.Tensor, h: int, w: int, cfg: EGVSRConfig) -> torch.Tensor:
    """scale * upsample(flow) (reference net_utils.py:36-166): BI ->
    bilinear align_corners=False, BD -> the TecoGAN bicubic; both in the
    flow's dtype, the product rounded once, as the JAX package does."""
    s = cfg.scale
    if cfg.degradation == "BD":
        up = upsample_tecogan(flow, s)
    else:
        up = resize(flow, (h * s, w * s), "bilinear")
    return up * float(s)


def init_params(
    generator: torch.Generator,
    cfg: EGVSRConfig = DEFAULT,
    device: str | torch.device = "cpu",
) -> dict:
    """He-normal random weights drawn from `generator` (on the CPU, then
    moved to `device`), with the JAX package's small inits: the last flow
    conv x 1e-2 (a fresh FNet predicts about zero flow) and conv_out x 0.1
    (a fresh net emits about zero HR)."""

    def conv(i, o, scale=1.0):
        w = torch.randn((3, 3, i, o), generator=generator) * np.sqrt(2.0 / (i * 9))
        return {"w": w * scale, "b": torch.zeros(o)}

    c = cfg.in_nc
    fnet = {
        "enc1": [conv(2 * c, 32), conv(32, 32)],
        "enc2": [conv(32, 64), conv(64, 64)],
        "enc3": [conv(64, 128), conv(128, 128)],
        "dec1": [conv(128, 256), conv(256, 256)],
        "dec2": [conv(256, 128), conv(128, 128)],
        "dec3": [conv(128, 64), conv(64, 64)],
        "flow": [conv(64, 32), conv(32, 2, 1e-2)],
    }
    srnet = {
        "conv_in": conv((cfg.scale**2 + 1) * c, cfg.nf),
        "blocks": [[conv(cfg.nf, cfg.nf), conv(cfg.nf, cfg.nf)] for _ in range(cfg.nb)],
        "conv_out": conv(cfg.nf // 16, cfg.out_nc, 0.1),
    }
    return to_tensors({"fnet": fnet, "srnet": srnet}, device)


def _enc(p, x):
    x = leaky_relu(conv2d(x, p[0]["w"], p[0]["b"], padding=1), 0.2)
    return leaky_relu(conv2d(x, p[1]["w"], p[1]["b"], padding=1), 0.2)


def fnet_apply(params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Optical flow x1 -> x2.  Inputs NHWC in [0,1]; output (N, H', W', 2)
    with H' = H//8*8 (the caller reflect-pads it back to H)."""
    p = params
    out = max_pool2(_enc(p["enc1"], torch.cat([x1, x2], dim=-1)))
    out = max_pool2(_enc(p["enc2"], out))
    out = max_pool2(_enc(p["enc3"], out))
    h, w = out.shape[-3], out.shape[-2]
    out = resize(_enc(p["dec1"], out), (h * 2, w * 2), "bilinear")
    out = resize(_enc(p["dec2"], out), (h * 4, w * 4), "bilinear")
    out = resize(_enc(p["dec3"], out), (h * 8, w * 8), "bilinear")
    out = leaky_relu(conv2d(out, p["flow"][0]["w"], p["flow"][0]["b"], padding=1), 0.2)
    out = conv2d(out, p["flow"][1]["w"], p["flow"][1]["b"], padding=1)
    return torch.tanh(out) * 24.0


def _fold_conv_out(w: torch.Tensor, b: torch.Tensor, s: int):
    """Fold the post-pixel-shuffle 3x3 conv_out back to LR resolution:
    conv_out(relu(pixel_shuffle(y, s))) == pixel_shuffle(conv_lr(relu(y),
    W_lr), s) exactly, with W_lr[(dY,dX), (c,a,b), (o,i,j)] =
    W[(a-i+s*dY, b-j+s*dX), c, o] where that HR offset lies in the 3x3
    support, else 0.  Returns (W_lr, b_lr, padding)."""
    kh, kw, c_hr, o_hr = w.shape
    iy, ix, m = _fold_tables(kh, s, w.device)
    wg = w[iy, ix]                                  # (D,a,i, E,b,j, c, o)
    wg = wg * m.to(w.dtype)[..., None, None]
    wg = wg.permute(0, 3, 6, 1, 4, 7, 2, 5)         # D,E,c,a,b,o,i,j
    d = iy.shape[0]
    w_lr = wg.reshape(d, d, c_hr * s * s, o_hr * s * s)
    return w_lr, b.repeat_interleave(s * s), d // 2


@lru_cache(maxsize=None)
def _fold_tables(kh: int, s: int, device: torch.device):
    """The fold's gather indices and validity mask on `device`, made once:
    a copy from host memory on every step would make the host wait for
    the device's queue to drain."""
    off = kh // 2
    dY = np.arange(-(off // s + 1), off // s + 2)  # LR taps that can hit
    a = np.arange(s)
    grid = a[None, :, None] - a[None, None, :] + s * dY[:, None, None]
    valid = np.abs(grid) <= off                     # (D, a, i)
    idx = np.clip(grid + off, 0, kh - 1)
    iy = torch.from_numpy(idx[:, :, :, None, None, None]).to(device)
    ix = torch.from_numpy(idx[None, None, None, :, :, :]).to(device)
    m = torch.from_numpy(valid[:, :, :, None, None, None] & valid[None, None, None]).to(device)
    return iy, ix, m


def srnet_apply(params: dict, lr_curr: torch.Tensor, hr_prev_tran: torch.Tensor) -> torch.Tensor:
    """lr_curr (N,H,W,c) + the space-to-depth'd warped hr_prev
    (N,H,W,s^2*c) -> (N, 4H, 4W, out_nc)."""
    p = params
    x = torch.cat([lr_curr, hr_prev_tran.to(lr_curr.dtype)], dim=-1)
    y = torch.relu(conv2d(x, p["conv_in"]["w"], p["conv_in"]["b"], padding=1))
    for blk in p["blocks"]:
        r = torch.relu(conv2d(y, blk[0]["w"], blk[0]["b"], padding=1))
        y = conv2d(r, blk[1]["w"], blk[1]["b"], padding=1) + y
    w_lr, b_lr, pad = _fold_conv_out(p["conv_out"]["w"], p["conv_out"]["b"], 4)
    z = conv2d(torch.relu(y), w_lr, b_lr, padding=pad)
    return pixel_shuffle(z, 4)


def _hr_flow(params: dict, lr_curr: torch.Tensor, lr_prev: torch.Tensor, cfg: EGVSRConfig):
    """FNet's flow lr_curr -> lr_prev, reflect-padded back to the LR size,
    upsampled and scaled to HR pixels."""
    h, w = lr_curr.shape[-3], lr_curr.shape[-2]
    flow = fnet_apply(params["fnet"], lr_curr, lr_prev)
    pad_h, pad_w = h - flow.shape[-3], w - flow.shape[-2]
    if pad_h or pad_w:
        flow = pad2d(flow, (0, pad_w, 0, pad_h), mode="reflect")
    return _upsample_flow(flow, h, w, cfg)


def _cut_flags(lr_curr: torch.Tensor, lr_prev: torch.Tensor, threshold: float) -> torch.Tensor:
    """Scene-cut test mean|lr_curr - lr_prev| > threshold over all but the
    leading axis, as bool tensors on the device (nothing is fetched)."""
    diff = (lr_curr.float() - lr_prev.float()).abs()
    return diff.flatten(1).mean(dim=1) > threshold


def frnet_step(
    params: dict,
    lr_curr: torch.Tensor,
    lr_prev: torch.Tensor,
    hr_prev: torch.Tensor,
    *,
    cfg: EGVSRConfig = DEFAULT,
    cut_threshold: float | None = None,
) -> torch.Tensor:
    """One recurrence step (reference FRNet.forward, egvsr.py:180-212).

    The HR warp goes through K3's wrapper (the CUDA kernel on a CUDA
    tensor, its plain version on a CPU one).  cut_threshold: when mean
    |lr_curr - lr_prev| exceeds it, the frame is a scene cut and hr_prev goes to
    SRNet unwarped (the zero-flow warp), as the JAX package's lax.cond
    does; the test runs on the device and the warp copies hr_prev."""
    s = cfg.scale
    hr_flow = _hr_flow(params, lr_curr, lr_prev, cfg)
    skip = None
    if cut_threshold is not None:
        skip = _cut_flags(lr_curr[None], lr_prev[None], cut_threshold)
    hr_tran = backward_warp_fast(hr_prev, hr_flow, s2d_out=s, skip=skip).to(lr_curr.dtype)
    return srnet_apply(params["srnet"], lr_curr, hr_tran)


def init_recurrent_state(
    n: int, h: int, w: int, cfg: EGVSRConfig = DEFAULT,
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cpu",
):
    """(lr_prev, hr_prev) zero state for a fresh stream."""
    s = cfg.scale
    return (
        torch.zeros((n, h, w, cfg.in_nc), dtype=dtype, device=device),
        torch.zeros((n, h * s, w * s, cfg.out_nc), dtype=dtype, device=device),
    )


def infer_step(
    params, state, lr_curr, *,
    cfg: EGVSRConfig = DEFAULT, cut_threshold: float | None = None,
):
    """Streaming step carrying (lr_prev, hr_prev) (reference
    egvsr_upscaler.py:197-207).  Returns (hr, new_state)."""
    lr_prev, hr_prev = state
    hr = frnet_step(params, lr_curr, lr_prev, hr_prev, cfg=cfg, cut_threshold=cut_threshold)
    return hr, (lr_curr, hr)


def infer_sequence(params: dict, lr_data: torch.Tensor, *, cfg: EGVSRConfig = DEFAULT) -> torch.Tensor:
    """Whole-clip streaming inference: lr_data (T, N, H, W, C) ->
    (T, N, sH, sW, C)."""
    t, n, h, w, _ = lr_data.shape
    state = init_recurrent_state(n, h, w, cfg, lr_data.dtype, lr_data.device)
    outs = []
    for lr in lr_data:
        hr, state = infer_step(params, state, lr, cfg=cfg)
        outs.append(hr)
    return torch.stack(outs)


def infer_chunk(
    params: dict,
    state: tuple,
    lr_chunk: torch.Tensor,
    *,
    cfg: EGVSRConfig = DEFAULT,
    cut_threshold: float | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Streaming inference over a micro-batch with FNet batched:
    lr_chunk (T, N, H, W, C) -> ((T, N, sH, sW, C), new_state).  The same
    recurrence as T x infer_step, but FNet runs once at batch T*N; only
    the warp + SRNet recurrence loops."""
    t, n, h, w, c = lr_chunk.shape
    s = cfg.scale
    lr_prev0, hr = state
    prevs = torch.cat([lr_prev0[None].to(lr_chunk.dtype), lr_chunk[:-1]], dim=0)
    hr_flow = _hr_flow(params, lr_chunk.reshape(t * n, h, w, c), prevs.reshape(t * n, h, w, c), cfg)
    hr_flow = hr_flow.reshape(t, n, h * s, w * s, 2)
    skips = None if cut_threshold is None else _cut_flags(lr_chunk, prevs, cut_threshold)
    outs = []
    for i in range(t):
        skip = None if skips is None else skips[i : i + 1]
        hr_tran = backward_warp_fast(hr, hr_flow[i], s2d_out=s, skip=skip).to(lr_chunk.dtype)
        hr = srnet_apply(params["srnet"], lr_chunk[i], hr_tran)
        outs.append(hr)
    return torch.stack(outs), (lr_chunk[-1], hr)


def pad_sequence(lr_data: torch.Tensor, n_pad_front: int = 0, padding_mode: str = "reflect"):
    """Temporal padding for streaming inference (reference
    models/base_model.py:91-117): prepend n_pad_front frames so the
    recurrence warms up before the first real frame.  lr_data: (T, ...)
    frame-major.  Returns (padded, n_pad_front)."""
    if n_pad_front == 0:
        return lr_data, 0
    if padding_mode == "reflect":
        head = torch.flip(lr_data[1 : 1 + n_pad_front], dims=(0,))
        return torch.cat([head, lr_data]), n_pad_front
    if padding_mode == "replicate":
        head = lr_data[:1].expand((n_pad_front,) + tuple(lr_data.shape[1:]))
        return torch.cat([head, lr_data]), n_pad_front
    if padding_mode == "dual-reflect":
        head = torch.flip(lr_data[1 : 1 + n_pad_front], dims=(0,))
        tail = torch.flip(lr_data[-1 - n_pad_front : -1], dims=(0,))
        return torch.cat([head, lr_data, tail]), n_pad_front
    raise ValueError(f"unrecognized padding mode: {padding_mode}")


def config_from_torch(sd: dict[str, np.ndarray]) -> EGVSRConfig:
    """The FRNet shape of a torch state dict: nb from the count of
    srnet.resblocks.<i> blocks, nf and in/out_nc from conv shapes, and BD
    where the reference's BicubicUpsample buffer (upsample_func.kernels)
    is present, else BI."""
    nb = len({
        int(k.split(".")[2])
        for k in sd
        if k.startswith("srnet.resblocks.") and k.endswith(".conv.0.weight")
    })
    w_in = sd["srnet.conv_in.0.weight"]          # (nf, (s^2+1)*c, 3, 3)
    scale = 4
    bd = any("upsample_func.kernels" in k for k in sd)
    return EGVSRConfig(
        in_nc=int(w_in.shape[1]) // (scale**2 + 1), out_nc=int(sd["srnet.conv_out.weight"].shape[0]),
        nf=int(w_in.shape[0]), nb=nb, scale=scale, degradation="BD" if bd else "BI",
    )


def from_torch(
    sd: dict[str, np.ndarray], cfg: EGVSRConfig = DEFAULT, device: str | torch.device = "cpu",
) -> dict:
    """Key map of the reference FNet/SRNet modules (egvsr.py:16-130)."""
    stages = {"enc1": "encoder1", "enc2": "encoder2", "enc3": "encoder3",
              "dec1": "decoder1", "dec2": "decoder2", "dec3": "decoder3", "flow": "flow"}
    fnet = {
        k: [conv_from_torch(sd, f"fnet.{name}.0."), conv_from_torch(sd, f"fnet.{name}.2.")]
        for k, name in stages.items()
    }
    srnet = {
        "conv_in": conv_from_torch(sd, "srnet.conv_in.0."),
        "blocks": [
            [conv_from_torch(sd, f"srnet.resblocks.{i}.conv.0."),
             conv_from_torch(sd, f"srnet.resblocks.{i}.conv.2.")]
            for i in range(cfg.nb)
        ],
        "conv_out": conv_from_torch(sd, "srnet.conv_out."),
    }
    return to_tensors({"fnet": fnet, "srnet": srnet}, device)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's EGVSR pytree (leaves as numpy arrays) as tensors."""
    return to_tensors(np_params, device)
