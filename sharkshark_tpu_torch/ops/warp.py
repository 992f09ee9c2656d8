"""Backward warping (flow-based bilinear resampling) for EGVSR's
recurrence (counterpart of the JAX package's ops/warp.py).

- `grid_sample_bilinear` and `backward_warp` are the plain functions:
  grid_sample semantics with align_corners=True and border clamp, repeating
  the JAX arithmetic step by step (a linspace-normalised grid, then
  de-normalised, clamped to [0, size-1], floor, 4 taps), so that they hold
  the JAX functions tightly.  They are the reference of the kernel below.
  `backward_warp_ac0` is the STN warp of the VESPCN / SOF-VSR variants
  (align_corners=False), mapped onto the same sampler.
- `backward_warp_fast` is the wrapper of K3, the CUDA kernel
  `csrc/backward_warp.cu` (counterpart of the JAX package's Pallas kernel
  ops/pallas/warp_band.py::banded_backward_warp), which calls the
  operator `torch.ops.sharkshark.backward_warp` (ops/_library.py): its
  CPU implementation is the plain version `backward_warp_plain`, its
  CUDA implementation launches the kernel or raises (it never falls
  back), and its fake implementation gives the output's shape and
  dtype, so that torch.export can trace a caller.  The operator is
  inference-only (no backward; the wrapper raises where autograd would
  need one).  `launches` counts kernel launches.

Two options ride on the warp: `s2d_out=s` returns
space_to_depth(warp(x), s) (the layout SRNet consumes), and `skip`, a
one-element bool tensor on x's device, returns x unwarped when it is set
(EGVSR's scene-cut skip, decided on the device so that no frame waits
for the host).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _library
from .nn import space_to_depth

__all__ = [
    "grid_sample_bilinear",
    "backward_warp",
    "backward_warp_ac0",
    "backward_warp_plain",
    "backward_warp_fast",
    "launches",
    "KERNEL_DTYPES",
]

# kernel launches since import (or since a caller last reset it)
launches = 0

# dtypes the kernel takes for x (and for the flow), with their code in
# the C interface
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 4
# the space_to_depth factors the kernel is built for (1 = NHWC): its lanes
# split an s-row strip of s x s blocks into s / 2 columns of 32 pixels
S2D_FACTORS = (1, 2, 4)


def _linspace(n: int, device) -> torch.Tensor:
    """jnp.linspace(-1, 1, n) in float32, by the same formula: with
    t = i / (n-1) (computed, as XLA does, as i times 1/(n-1)),
    -1 * (1 - t) + 1 * t, and the end point appended."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    div = n - 1
    t = torch.arange(div, dtype=torch.float32, device=device) * _recip(div)
    out = -1.0 * (1.0 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, device=device)])


def _recip(d: float) -> float:
    """1/d rounded to float32: XLA turns the JAX package's division by the
    constant d into a product with this reciprocal."""
    return float(np.float32(1.0) / np.float32(d))


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with border padding and align_corners=True.

    x: (N, H, W, C); grid: (N, H', W', 2) normalised coords in [-1, 1],
    grid[..., 0] = x (width), grid[..., 1] = y (height).  Computed in
    float32, returned in x's dtype."""
    n, h, w, c = x.shape
    gh, gw = grid.shape[1], grid.shape[2]
    gf = grid.float()

    # align_corners=True: -1 -> 0, +1 -> size-1
    fx = (gf[..., 0] + 1.0) * ((w - 1) / 2.0)
    fy = (gf[..., 1] + 1.0) * ((h - 1) / 2.0)
    fx = torch.clamp(fx, 0.0, w - 1)
    fy = torch.clamp(fy, 0.0, h - 1)

    x0 = torch.clamp(torch.floor(fx), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    flat = x.reshape(n, h * w, c).float()

    def gather(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(n, gh * gw, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(n, gh, gw, c)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp `x` backward along `flow` (both NHWC; flow has C=2 = (dx, dy)
    in pixels): x sampled at (u + dx, v + dy), through the normalised grid
    as the JAX package builds it."""
    n, h, w, _ = x.shape
    iu = _linspace(w, x.device)[None, None, :]
    iv = _linspace(h, x.device)[None, :, None]
    gx = iu + flow[..., 0].float() * _recip((w - 1.0) / 2.0)
    gy = iv + flow[..., 1].float() * _recip((h - 1.0) / 2.0)
    return grid_sample_bilinear(x, torch.stack([gx, gy], dim=-1))


def backward_warp_ac0(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """STN-style warp (reference utils/motion.py:51-91): flow in pixels,
    normalised by the size (not size-1), sampled as grid_sample does with
    align_corners=False and border padding.  The align_corners=False
    coordinates are mapped into the align_corners=True sampler's frame,
    pixel = (g + 1) / 2 * size - 0.5, by the JAX package's formula, term
    for term (its divisions stay divisions: this equals the JAX function
    run op by op bit for bit, and its jitted form within 5e-5 at 180x320)."""
    n, h, w, _ = x.shape
    ar = torch.arange(max(h, w), dtype=torch.float32, device=x.device) + 0.5
    iu = (ar[:w] / w * 2.0 - 1.0)[None, None, :]
    iv = (ar[:h] / h * 2.0 - 1.0)[None, :, None]
    gx = iu + flow[..., 0].float() / w * 2.0
    gy = iv + flow[..., 1].float() / h * 2.0
    px = (gx + 1.0) * (w / 2.0) - 0.5
    py = (gy + 1.0) * (h / 2.0) - 0.5
    g1x = px / ((w - 1.0) / 2.0) - 1.0
    g1y = py / ((h - 1.0) / 2.0) - 1.0
    return grid_sample_bilinear(x, torch.stack([g1x, g1y], dim=-1))


def backward_warp_plain(
    x: torch.Tensor,
    flow: torch.Tensor,
    *,
    s2d_out: int = 0,
    skip: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3's function in plain PyTorch: backward_warp(x, flow), or x itself
    where `skip` is set, then space_to_depth by s2d_out (0 = NHWC)."""
    y = backward_warp(x, flow)
    if skip is not None:
        y = torch.where(skip.reshape(()).to(torch.bool), x, y)
    return space_to_depth(y, s2d_out) if s2d_out else y


def _check(name: str, a: torch.Tensor, shape: tuple | None, device: torch.device) -> None:
    if shape is not None and tuple(a.shape) != shape:
        raise ValueError(f"backward_warp: {name} has shape {tuple(a.shape)}, expected {shape}")
    if a.device != device:
        raise ValueError(f"backward_warp: {name} is on {a.device}, x on {device}")
    if not a.is_contiguous():
        raise ValueError(f"backward_warp: {name} must be contiguous")


_kernel = None


def _kernel_fn():
    """The kernel's C function, built, loaded and typed once per process."""
    global _kernel
    if _kernel is None:
        from . import _build

        fn = _build.load("backward_warp").backward_warp
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _launch(x, flow, s2d_out, skip):
    global launches
    if x.ndim != 4:
        raise ValueError(f"backward_warp: x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    dev = x.device
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"backward_warp: the CUDA kernel takes 1 to {MAX_CHANNELS} channels, got {c}")
    for name, a in (("x", x), ("flow", flow)):
        if a.dtype not in KERNEL_DTYPES:
            raise TypeError(f"backward_warp: the CUDA kernel takes {name} in "
                            f"{sorted(map(str, KERNEL_DTYPES))}, got {a.dtype}")
    _check("x", x, (n, h, w, c), dev)
    _check("flow", flow, (n, h, w, 2), dev)
    # the kernel reads x and the flow by aligned 16-byte vectors
    for name, a in (("x", x), ("flow", flow)):
        if a.data_ptr() % 16:
            raise ValueError(f"backward_warp: {name} must be 16-byte aligned")
    s = s2d_out or 1
    if s < 1 or h % s or w % s:
        raise ValueError(f"backward_warp: s2d_out={s2d_out} must divide H={h} and W={w}")
    if s not in S2D_FACTORS:
        raise ValueError(f"backward_warp: the CUDA kernel takes s2d_out in {(0, *S2D_FACTORS)}, got {s2d_out}")
    if skip is not None:
        if skip.dtype != torch.bool or skip.numel() != 1:
            raise TypeError(f"backward_warp: skip must be one bool, got {skip.dtype} {tuple(skip.shape)}")
        _check("skip", skip, None, dev)
    out = torch.empty((n, h // s, w // s, s * s * c), dtype=x.dtype, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), flow.data_ptr(), 0 if skip is None else skip.data_ptr(),
                 out.data_ptr(), n, h, w, c, s, KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[flow.dtype],
                 stream)
    if err:
        raise RuntimeError(f"backward_warp: CUDA kernel launch failed with cudaError_t {err}")
    launches += 1
    return out


def _op_cpu(x, flow, skip, s2d_out):
    return backward_warp_plain(x, flow, s2d_out=s2d_out, skip=skip).contiguous()


def _op_cuda(x, flow, skip, s2d_out):
    return _launch(x, flow, s2d_out, skip)


def _op_fake(x, flow, skip, s2d_out):
    n, h, w, c = x.shape
    s = s2d_out or 1
    return x.new_empty((n, h // s, w // s, s * s * c))


_op = _library.define("backward_warp(Tensor x, Tensor flow, Tensor? skip, int s2d_out) -> Tensor",
                      cpu=_op_cpu, cuda=_op_cuda, fake=_op_fake)


def backward_warp_fast(
    x: torch.Tensor,
    flow: torch.Tensor,
    *,
    s2d_out: int = 0,
    skip: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3: the warp of backward_warp_plain, any flow, any N, H and W.
    Through the operator: a CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (x and flow float32 or bf16, contiguous
    and 16-byte aligned, 1 to 4 channels, s2d_out 0, 1, 2 or 4) or
    raises.  Inference-only: raises if x or flow requires grad.
    The kernel samples at u + dx directly, in float32, and returns x's
    dtype."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"backward_warp: no kernel for device {x.device}")
    _library.refuse_grad("backward_warp_fast", x, flow)
    return _op(x, flow, skip, s2d_out)
