"""Temporal-shift 3x3 conv for BSVD's buffered convs: the CUDA kernels
`csrc/tsm_conv.cu` (K1, counterpart of the JAX package's Pallas kernel
ops/pallas/tsm_conv.py::tsm_conv) and `csrc/tsm_conv_pair.cu` (K2, a mem
block's two convs in one launch, counterpart of tsm_conv_pair), and their
plain PyTorch versions.

Over a chunk x of frames [a, a+T) with carry prev1 = x_{a-1} and
left0 = x_{a-2}[..., fold:2fold] (fold = C/8), output j is
act(conv3x3_zeropad(m_j) + b), where m_j takes channels [0, fold) from
x_j, [fold, 2fold) from frame j-2 and [2fold, C) from frame j-1.

`tsm_conv` and `tsm_conv_pair` run the plain version for a tensor on the
CPU and the kernel for a tensor on a CUDA device; on CUDA they launch the
kernel or raise, they never fall back.  `launches` counts K1's launches,
`pair_launches` K2's.
"""

from __future__ import annotations

import ctypes

import torch

from .nn import conv2d, relu6

__all__ = [
    "tsm_conv", "tsm_conv_plain", "tsm_conv_pair", "tsm_conv_pair_plain",
    "launches", "pair_launches", "KERNEL_CHANNELS",
]

# kernel launches since import (or since a caller last reset them)
launches = 0
pair_launches = 0

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


def _kernel_shape(name, x, act):
    """(T, N, H, W, C) of a kernel's x, after the checks both kernels share."""
    if act not in _ACT:
        raise ValueError(f"{name}: act must be one of {sorted(_ACT)}, got {act!r}")
    if x.ndim != 5:
        raise ValueError(f"{name}: x must be (T, N, H, W, C) or (T, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"{name}: the CUDA kernel takes C in {KERNEL_CHANNELS}, got {c}")
    return x.shape


def _weights(w, b, c, dev):
    w = w.to(torch.bfloat16).contiguous()
    b = (torch.zeros(c, device=dev) if b is None else b).to(torch.bfloat16).contiguous()
    return w, b


def _launch(x, prev1, left0, w, b, act):
    global launches
    from . import _build

    squeeze = x.ndim == 4
    if squeeze:
        x, prev1, left0 = x[:, None], prev1[None], left0[None]
    t, n, h, wd, c = _kernel_shape("tsm_conv", x, act)
    dev = x.device
    w, b = _weights(w, b, c, dev)
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


def tsm_conv_pair_plain(
    x: torch.Tensor,
    prev1_x: torch.Tensor,
    left0_x: torch.Tensor,
    prev1_y: torch.Tensor,
    left0_y: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor | None,
    w2: torch.Tensor,
    b2: torch.Tensor | None,
    act: str = "relu6",
) -> tuple[torch.Tensor, torch.Tensor]:
    """A BSVD mem block's two temporal-shift convs in plain PyTorch:
    y1 = tsm_conv(x) with c1's carry (prev1_x, left0_x), then
    y2 = tsm_conv(y1) with c2's carry (prev1_y = y1 of frame a-1,
    left0_y = its fold slice of frame a-2).  Shapes as tsm_conv_plain,
    T >= 2.  Returns (y2, y1_last2): y1_last2 is y1 of the chunk's last
    two frames, (2, N, H, W, C) or (2, H, W, C), c2's next carry."""
    y1 = tsm_conv_plain(x, prev1_x, left0_x, w1, b1, act)
    y2 = tsm_conv_plain(y1, prev1_y, left0_y, w2, b2, act)
    return y2, y1[-2:]


def _launch_pair(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, act):
    global pair_launches
    from . import _build

    squeeze = x.ndim == 4
    if squeeze:
        x, prev1_x, left0_x = x[:, None], prev1_x[None], left0_x[None]
        prev1_y, left0_y = prev1_y[None], left0_y[None]
    t, n, h, wd, c = _kernel_shape("tsm_conv_pair", x, act)
    if t < 2:
        raise ValueError(f"tsm_conv_pair: the CUDA kernel takes T >= 2, got {t}")
    dev = x.device
    w1, b1 = _weights(w1, b1, c, dev)
    w2, b2 = _weights(w2, b2, c, dev)
    _check("x", x, (t, n, h, wd, c), dev)
    for name, a in (("prev1_x", prev1_x), ("prev1_y", prev1_y)):
        _check(name, a, (n, h, wd, c), dev)
    for name, a in (("left0_x", left0_x), ("left0_y", left0_y)):
        _check(name, a, (n, h, wd, c // 8), dev)
    for name, a in (("w1", w1), ("w2", w2)):
        _check(name, a, (3, 3, c, c), dev)
    for name, a in (("b1", b1), ("b2", b2)):
        _check(name, a, (c,), dev)
    out = torch.empty_like(x)
    carry = torch.empty((2, n, h, wd, c), dtype=x.dtype, device=dev)
    lib = _build.load("tsm_conv_pair")
    fn = lib.tsm_conv_pair_bf16
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), prev1_x.data_ptr(), left0_x.data_ptr(), prev1_y.data_ptr(),
                 left0_y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 out.data_ptr(), carry.data_ptr(), t, n, h, wd, c, _ACT[act], stream)
    if err:
        raise RuntimeError(f"tsm_conv_pair: CUDA kernel launch failed with cudaError_t {err}")
    pair_launches += 1
    if squeeze:
        return out[:, 0], carry[:, 0]
    return out, carry


def tsm_conv_pair(
    x: torch.Tensor,
    prev1_x: torch.Tensor,
    left0_x: torch.Tensor,
    prev1_y: torch.Tensor,
    left0_y: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor | None,
    w2: torch.Tensor,
    b2: torch.Tensor | None,
    act: str = "relu6",
) -> tuple[torch.Tensor, torch.Tensor]:
    """A mem block's two temporal-shift convs in one launch; shapes and
    result as tsm_conv_pair_plain.  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel (bf16, contiguous, 16-byte aligned,
    T >= 2, C in KERNEL_CHANNELS) or raises."""
    if x.device.type == "cpu":
        return tsm_conv_pair_plain(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, act)
    if x.device.type != "cuda":
        raise ValueError(f"tsm_conv_pair: no kernel for device {x.device}")
    return _launch_pair(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, act)
