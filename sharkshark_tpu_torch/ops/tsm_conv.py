"""Temporal-shift 3x3 conv for BSVD's buffered convs: the CUDA kernel
`csrc/tsm_conv.cu` (K1, counterpart of the JAX package's Pallas kernel
ops/pallas/tsm_conv.py::tsm_conv), a mem block's two convs as two chained
K1 launches (K2, counterpart of tsm_conv_pair), and their plain PyTorch
versions.

Over a chunk x of frames [a, a+T) with carry prev1 = x_{a-1} and
left0 = x_{a-2}[..., fold:2fold] (fold = C/8), output j is
act(conv3x3_zeropad(m_j) + b), where m_j takes channels [0, fold) from
x_j, [fold, 2fold) from frame j-2 and [2fold, C) from frame j-1.

K1 is the operator `torch.ops.sharkshark.tsm_conv` (ops/_library.py; x
always (T, N, H, W, C)): its CUDA implementation launches the kernel, its
CPU implementation is the plain version, and its fake implementation
gives the output's shape and dtype, so that torch.export can trace a
caller.  `tsm_conv` and `tsm_conv_pair` call through the operator: the
plain version for a tensor on the CPU, the kernel for a tensor on a CUDA
device, where they launch the kernel or raise; they never fall back.
The operator is inference-only: the wrappers raise where autograd would
differentiate through it (the CPU pair runs its plain version, which
autograd can).  `launches` counts K1's launches (two for each K2 call),
`launches_by_device` the same by CUDA device index, `pair_launches`
K2's calls.

K2 is not a kernel of its own: fusing the pair cannot pay on an H100.
Holding y1 over each tile's halo costs 1.27x conv1's MACs, which puts a
fused kernel's bound above two K1 launches' at C=128 and within 3 % of
it at C=64, and both convs' taps would not fit in shared memory beside
each other (at C=128 one conv's already do not).
"""

from __future__ import annotations

import ctypes

import torch

from . import _library
from .nn import conv2d, relu6

__all__ = [
    "tsm_conv", "tsm_conv_plain", "tsm_conv_pair", "tsm_conv_pair_plain",
    "kernel_schedule", "launches", "launches_by_device", "pair_launches", "KERNEL_CHANNELS",
]

# kernel launches since import (or since a caller last reset them)
launches = 0
launches_by_device: dict[int, int] = {}
pair_launches = 0

KERNEL_CHANNELS = (64, 128)
_ACT = {"none": 0, "relu": 1, "relu6": 2}


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return y
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


_kernel = None


def _kernel_fn():
    """K1's C function, built, loaded and typed once per process."""
    global _kernel
    if _kernel is None:
        from . import _build

        fn = _build.load("tsm_conv").tsm_conv_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _launch(x, prev1, left0, w, b, act):
    """K1's CUDA implementation: the checks, then one launch on the
    current stream, x (T, N, H, W, C)."""
    global launches
    t, n, h, wd, c = _kernel_shape("tsm_conv", x, act)
    dev = x.device
    w, b = _weights(w, b, c, dev)
    _check("x", x, (t, n, h, wd, c), dev)
    _check("prev1", prev1, (n, h, wd, c), dev)
    _check("left0", left0, (n, h, wd, c // 8), dev)
    _check("w", w, (3, 3, c, c), dev)
    _check("b", b, (c,), dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(x.data_ptr(), prev1.data_ptr(), left0.data_ptr(), w.data_ptr(),
                           b.data_ptr(), out.data_ptr(), t, n, h, wd, c, _ACT[act], stream)
    if err:
        raise RuntimeError(f"tsm_conv: CUDA kernel launch failed with cudaError_t {err}")
    launches += 1
    launches_by_device[dev.index] = launches_by_device.get(dev.index, 0) + 1
    return out


def _op_cpu(x, prev1, left0, w, b, act):
    return tsm_conv_plain(x, prev1, left0, w, b, act).contiguous()


def _op_fake(x, prev1, left0, w, b, act):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


_op = _library.define("tsm_conv(Tensor x, Tensor prev1, Tensor left0, Tensor w, Tensor? b, str act) -> Tensor",
                      cpu=_op_cpu, cuda=_launch, fake=_op_fake)


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def kernel_schedule(t: int, n: int, h: int, w: int, c: int) -> tuple[int, int]:
    """(spatial tiles, blocks) of K1's persistent grid for a chunk of this
    shape on the current CUDA device.  Each tile is computed by C/64
    blocks, one per 64 output channels; each block walks its tiles."""
    from . import _build

    fn = _build.load("tsm_conv").tsm_conv_schedule
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    tiles, blocks = ctypes.c_int(), ctypes.c_int()
    err = fn(t, n, h, w, c, ctypes.byref(tiles), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"tsm_conv_schedule failed with cudaError_t {err}")
    return tiles.value, blocks.value


def tsm_conv(
    x: torch.Tensor,
    prev1: torch.Tensor,
    left0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    act: str = "relu6",
) -> torch.Tensor:
    """Temporal-shift 3x3 conv over a chunk; shapes as tsm_conv_plain.
    Through the operator: a CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (bf16, contiguous, C in KERNEL_CHANNELS)
    or raises.  Inference-only: raises if a tensor requires grad."""
    _check_device("tsm_conv", x)
    _library.refuse_grad("tsm_conv", x, prev1, left0, w, b)
    squeeze = x.ndim == 4
    if squeeze:
        x, prev1, left0 = x[:, None], prev1[None], left0[None]
    y = _op(x, prev1, left0, w, b, act)
    return y[:, 0] if squeeze else y


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
    # y1 is a fresh contiguous tensor, so it passes _check as x did; its
    # last two frames are a view that keeps y1 alive as c2's carry, as the
    # K1 route's carry (a view of y1's last frame) does
    y1 = _op(x, prev1_x, left0_x, w1, b1, act)
    y2 = _op(y1, prev1_y, left0_y, w2, b2, act)
    pair_launches += 1
    if squeeze:
        return y2[:, 0], y1[-2:, 0]
    return y2, y1[-2:]


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
    """A mem block's two temporal-shift convs; shapes and result as
    tsm_conv_pair_plain.  A CPU tensor runs the plain version; a CUDA
    tensor (bf16, contiguous, 16-byte aligned, T >= 2, C in
    KERNEL_CHANNELS) makes two K1 launches on the current stream through
    K1's operator, y1 then y2, or raises before either (also where a
    tensor requires grad)."""
    _check_device("tsm_conv_pair", x)
    if x.device.type == "cpu":
        return tsm_conv_pair_plain(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, act)
    _library.refuse_grad("tsm_conv_pair", x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2)
    return _launch_pair(x, prev1_x, left0_x, prev1_y, left0_y, w1, b1, w2, b2, act)
