"""L x [3x3 SAME conv + bias + PReLU] at 64 channels: the CUDA kernel
`csrc/conv_stack.cu` (K4, counterpart of the JAX package's Pallas kernel
experiments/conv_stack.py::fused_conv_stack) and its plain PyTorch
version.  SRVGG's body runs through it (models/srvgg.py, `conv_stack=L`).

Each layer accumulates in float32, adds its bias, applies PReLU with
per-channel alpha, and rounds once to x's dtype; with bias=None this is
the Pallas kernel's function exactly.

K4 is the operator `torch.ops.sharkshark.conv_stack` (ops/_library.py)
over the whole stack: its CUDA implementation runs the L layers as L
launches of the one-layer kernel on the current stream (one C call), its
CPU implementation is the plain version, and its fake implementation
gives the output's shape and dtype, so that torch.export can trace a
caller.  `fused_conv_stack` calls through the operator: the plain
version for a tensor on the CPU and the kernel for a tensor on a CUDA
device, where it launches the kernel or raises, it never falls back.
The operator is inference-only (no backward; the wrapper raises where
autograd would need one).  `launches` grows by L a call, and
`launches_by_device` by L at the CUDA device index.
`kernel_schedule` reports each launch's persistent grid.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _library

__all__ = ["fused_conv_stack", "fused_conv_stack_plain", "kernel_schedule", "launches", "launches_by_device",
           "CHANNELS", "L_MAX"]

# kernel launches since import (or since a caller last reset it)
launches = 0
launches_by_device: dict[int, int] = {}

CHANNELS = 64
# the deepest stack a call takes: the depths SRVGG's `conv_stack` and the
# tile path run and the tests cover (chained launches set no limit)
L_MAX = 4


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


_kernels = None


def _kernel_fns():
    """The kernel's C functions (the stack, the schedule), built, loaded
    and typed once per process."""
    global _kernels
    if _kernels is None:
        from . import _build

        lib = _build.load("conv_stack")
        stack, sched = lib.conv_stack_bf16, lib.conv_stack_schedule
        stack.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        stack.restype = ctypes.c_int
        sched.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
        sched.restype = ctypes.c_int
        _kernels = (stack, sched)
    return _kernels


def _launch(x, weights, alphas, bias):
    """K4's CUDA implementation: the checks, then L launches in one C call."""
    global launches
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
    # the layers take turns writing out and this buffer, the last one out
    scratch = torch.empty_like(x) if n_layers > 1 else None
    fn = _kernel_fns()[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), a.data_ptr(), out.data_ptr(),
                 0 if scratch is None else scratch.data_ptr(), n, h, wd, n_layers, stream)
    if err:
        raise RuntimeError(f"fused_conv_stack: CUDA kernel launch failed with cudaError_t {err}")
    launches += n_layers
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + n_layers
    return out


def kernel_schedule(n: int, h: int, w: int, n_layers: int = 1) -> tuple[int, int]:
    """(output tiles, blocks) of each of K4's launches for (n, h, w, 64)
    at depth n_layers on the current CUDA device: persistent blocks that
    walk the tiles, the same grid at every depth."""
    fn = _kernel_fns()[1]
    tiles, blocks = ctypes.c_int(), ctypes.c_int()
    err = fn(n, h, w, n_layers, ctypes.byref(tiles), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"conv_stack_schedule failed with cudaError_t {err}")
    return tiles.value, blocks.value


def _op_fake(x, weights, alphas, bias):
    return x.new_empty(x.shape)


_op = _library.define("conv_stack(Tensor x, Tensor weights, Tensor alphas, Tensor? bias) -> Tensor",
                      cpu=fused_conv_stack_plain, cuda=_launch, fake=_op_fake)


def fused_conv_stack(
    x: torch.Tensor,
    weights: torch.Tensor,
    alphas: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """L x [3x3 SAME conv + bias + PReLU]; shapes as
    fused_conv_stack_plain.  Through the operator: a CPU tensor runs the
    plain version; a CUDA tensor launches the kernel L times (x bf16,
    contiguous, any H and W, 1 <= L <= L_MAX) or raises before the first
    launch.  Inference-only: raises if a tensor requires grad."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_conv_stack: no kernel for device {x.device}")
    _library.refuse_grad("fused_conv_stack", x, weights, alphas, bias)
    return _op(x, weights, alphas, bias)
