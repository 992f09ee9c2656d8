"""Temporal-shift 3x3 conv for BSVD's buffered convs: the CUDA kernel
`csrc/tsm_conv.cu` (counterpart of the JAX package's Pallas kernel
ops/pallas/tsm_conv.py::tsm_conv) and its plain PyTorch version.

Over a chunk x of frames [a, a+T) with carry prev1 = x_{a-1} and
left0 = x_{a-2}[..., fold:2fold] (fold = C/8), output j is
act(conv3x3_zeropad(m_j) + b), where m_j takes channels [0, fold) from
x_j, [fold, 2fold) from frame j-2 and [2fold, C) from frame j-1.

`tsm_conv` runs the plain version for a tensor on the CPU and the kernel
for a tensor on a CUDA device; on CUDA it launches the kernel or raises,
it never falls back.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .nn import conv2d, relu6

__all__ = ["tsm_conv", "tsm_conv_plain", "launches", "KERNEL_CHANNELS"]

# kernel launches since import (or since a caller last reset it)
launches = 0

KERNEL_CHANNELS = (64, 128)
_ACT = {"relu": 1, "relu6": 2}


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu6":
        return relu6(y)
    if act == "relu":
        return torch.clamp(y, min=0)
    raise ValueError(act)


def tsm_conv_plain(
    x: torch.Tensor,
    prev1: torch.Tensor,
    left0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    act: str = "relu6",
) -> torch.Tensor:
    """The same function in plain PyTorch: build the mixed input, then
    one conv.  x: (T, N, H, W, C) with prev1 (N, H, W, C) and left0
    (N, H, W, C/8), or (T, H, W, C) with prev1 (H, W, C) and left0
    (H, W, C/8); w: (3, 3, C, Co) HWIO; b: (Co,) or None.  Any C that
    divides by 8."""
    squeeze = x.ndim == 4
    if squeeze:
        x, prev1, left0 = x[:, None], prev1[None], left0[None]
    t, n, h, wd, c = x.shape
    fold = c // 8
    fut = x[..., :fold]
    hist = torch.stack([left0, prev1[..., fold : 2 * fold]]).to(x.dtype)
    left = torch.cat([hist, x[: max(t - 2, 0), ..., fold : 2 * fold]], dim=0)[:t]
    rest = torch.cat([prev1[None, ..., 2 * fold :].to(x.dtype), x[: t - 1, ..., 2 * fold :]], dim=0)
    mix = torch.cat([fut, left, rest], dim=-1).reshape(t * n, h, wd, c)
    y = _act(conv2d(mix, w, b, padding=1), act)
    y = y.reshape(t, n, h, wd, y.shape[-1])
    return y[:, 0] if squeeze else y


def _check(name: str, a: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if tuple(a.shape) != shape:
        raise ValueError(f"tsm_conv: {name} has shape {tuple(a.shape)}, expected {shape}")
    if a.dtype != torch.bfloat16:
        raise TypeError(f"tsm_conv: the CUDA kernel takes bf16, got {name} {a.dtype}")
    if a.device != device:
        raise ValueError(f"tsm_conv: {name} is on {a.device}, x on {device}")
    if not a.is_contiguous():
        raise ValueError(f"tsm_conv: {name} must be contiguous")
    if a.data_ptr() % 16:
        raise ValueError(f"tsm_conv: {name} must be 16-byte aligned")


def _launch(x, prev1, left0, w, b, act):
    global launches
    from . import _build

    if act not in _ACT:
        raise ValueError(f"tsm_conv: act must be one of {sorted(_ACT)}, got {act!r}")
    squeeze = x.ndim == 4
    if squeeze:
        x, prev1, left0 = x[:, None], prev1[None], left0[None]
    if x.ndim != 5:
        raise ValueError(f"tsm_conv: x must be (T, N, H, W, C) or (T, H, W, C), got {tuple(x.shape)}")
    t, n, h, wd, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"tsm_conv: the CUDA kernel takes C in {KERNEL_CHANNELS}, got {c}")
    dev = x.device
    w = w.to(torch.bfloat16).contiguous()
    b = (torch.zeros(c, device=dev) if b is None else b).to(torch.bfloat16).contiguous()
    _check("x", x, (t, n, h, wd, c), dev)
    _check("prev1", prev1, (n, h, wd, c), dev)
    _check("left0", left0, (n, h, wd, c // 8), dev)
    _check("w", w, (3, 3, c, c), dev)
    _check("b", b, (c,), dev)
    out = torch.empty_like(x)
    lib = _build.load("tsm_conv")
    fn = lib.tsm_conv_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), prev1.data_ptr(), left0.data_ptr(), w.data_ptr(),
                 b.data_ptr(), out.data_ptr(), t, n, h, wd, c, _ACT[act], stream)
    if err:
        raise RuntimeError(f"tsm_conv: CUDA kernel launch failed with cudaError_t {err}")
    launches += 1
    return out[:, 0] if squeeze else out


def tsm_conv(
    x: torch.Tensor,
    prev1: torch.Tensor,
    left0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    act: str = "relu6",
) -> torch.Tensor:
    """Temporal-shift 3x3 conv over a chunk; shapes as tsm_conv_plain.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (bf16, contiguous, C in KERNEL_CHANNELS) or raises."""
    if x.device.type == "cpu":
        return tsm_conv_plain(x, prev1, left0, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"tsm_conv: no kernel for device {x.device}")
    return _launch(x, prev1, left0, w, b, act)
