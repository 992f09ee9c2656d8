"""L x [3x3 SAME conv + bias + PReLU] at 64 channels in one launch: the
CUDA kernel `csrc/conv_stack.cu` (K4, counterpart of the JAX package's
Pallas kernel experiments/conv_stack.py::fused_conv_stack) and its plain
PyTorch version.  SRVGG's body runs through it (models/srvgg.py,
`conv_stack=L`).

Each layer accumulates in float32, adds its bias, applies PReLU with
per-channel alpha, and rounds once to x's dtype; with bias=None this is
the Pallas kernel's function exactly.

`fused_conv_stack` runs the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA device; on CUDA it launches the kernel or
raises, it never falls back.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["fused_conv_stack", "fused_conv_stack_plain", "launches", "CHANNELS", "L_MAX"]

# kernel launches since import (or since a caller last reset it)
launches = 0

CHANNELS = 64
L_MAX = 4  # the kernel's deepest stack (csrc/conv_stack.cu: two layer buffers fit shared memory)


def _check_shapes(x, weights, alphas, bias):
    if x.ndim != 4 or x.shape[-1] != CHANNELS:
        raise ValueError(f"fused_conv_stack: x must be (N, H, W, {CHANNELS}), got {tuple(x.shape)}")
    n_layers = weights.shape[0]
    if tuple(weights.shape) != (n_layers, 3, 3, CHANNELS, CHANNELS) or n_layers < 1:
        raise ValueError(f"fused_conv_stack: weights must be (L, 3, 3, {CHANNELS}, {CHANNELS}), "
                         f"got {tuple(weights.shape)}")
    for name, a in (("alphas", alphas), ("bias", bias)):
        if a is not None and tuple(a.shape) != (n_layers, CHANNELS):
            raise ValueError(f"fused_conv_stack: {name} must be ({n_layers}, {CHANNELS}), got {tuple(a.shape)}")
    return n_layers


def fused_conv_stack_plain(
    x: torch.Tensor,
    weights: torch.Tensor,
    alphas: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same function in plain PyTorch.  x: (N, H, W, 64), any float
    dtype; weights: (L, 3, 3, 64, 64) HWIO; alphas: (L, 64); bias: (L, 64)
    or None.  Each layer computes in float32 and rounds to x's dtype."""
    n_layers = _check_shapes(x, weights, alphas, bias)
    y = x
    for l in range(n_layers):
        acc = F.conv2d(y.float().permute(0, 3, 1, 2), weights[l].float().permute(3, 2, 0, 1),
                       None if bias is None else bias[l].float(), padding=1)
        acc = torch.where(acc >= 0, acc, acc * alphas[l].float()[:, None, None])
        y = acc.permute(0, 2, 3, 1).to(x.dtype)
    return y.contiguous()


def _launch(x, weights, alphas, bias):
    global launches
    from . import _build

    n_layers = _check_shapes(x, weights, alphas, bias)
    if n_layers > L_MAX:
        raise ValueError(f"fused_conv_stack: the CUDA kernel takes L <= {L_MAX} layers, got {n_layers}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv_stack: the CUDA kernel takes bf16, got x {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_conv_stack: x must be contiguous and 16-byte aligned")
    dev = x.device
    w = weights.to(dev, torch.bfloat16).contiguous()
    a = alphas.to(dev, torch.float32).contiguous()
    b = (torch.zeros_like(a) if bias is None else bias.to(dev, torch.float32)).contiguous()
    n, h, wd, _ = x.shape
    out = torch.empty_like(x)
    lib = _build.load("conv_stack")
    fn = lib.conv_stack_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(),
                 n, h, wd, n_layers, stream)
    if err:
        raise RuntimeError(f"fused_conv_stack: CUDA kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


def fused_conv_stack(
    x: torch.Tensor,
    weights: torch.Tensor,
    alphas: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """L x [3x3 SAME conv + bias + PReLU]; shapes as
    fused_conv_stack_plain.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (x bf16, contiguous, any H and W,
    1 <= L <= L_MAX) or raises."""
    if x.device.type == "cpu":
        return fused_conv_stack_plain(x, weights, alphas, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_stack: no kernel for device {x.device}")
    return _launch(x, weights, alphas, bias)
