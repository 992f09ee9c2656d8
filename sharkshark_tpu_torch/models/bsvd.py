"""BSVD streaming video denoiser (counterpart of the JAX package's
models/bsvd.py): the single-frame path, the per-frame stream and the
chunked (layer-major) evaluation that the services run.

Two U-Net DenBlocks whose 3x3 convs inside the down/up stages are
bidirectional temporal-shift convs (reference src/upscale/model/bsvd/
model.py:22-588): the output aligned to frame g reads
[x_{g+1}[:fold] | x_{g-1}[fold:2fold] | x_g[2fold:]] of its own layer's
input.  Each conv carries the previous frame (`center`) and a
1/8-channel slice of the frame before it (`left`); the MemSkip FIFOs
carry the frames between push and pop.

- `apply_single` is the reference production path's collapsed form
  (fresh state and a full flush every call): every shift conv sees zeros
  in its first 2*fold channels, one feed-forward pass.
- `stream_step` feeds one frame a call, as the reference does, with
  every conv's state gated by its pipeline depth and the MemSkip FIFOs
  as rings; `denoise_clip` runs a whole clip through it, flush included.
  Its shift convs are the shift-and-concatenate conv on one frame.
- `chunk_step` runs every conv once per chunk of T frames, batched over
  the chunk; warm-up and end-of-clip flushing are a per-conv window mask
  over the chunk's global frame indices.  Chaining it over any split of
  a clip equals denoise_clip.  Its temporal-shift convs go through
  ops/tsm_conv.py: K1 on the card where the kernel is built for the
  width (C in tsm.KERNEL_CHANNELS: every shift conv of BSVD-32, the C=128
  ones of BSVD-64), the shift-and-concatenate conv elsewhere (BSVD-64's
  C=256), the plain versions on the CPU.  Training asks for
  `shift_conv="library"`, which routes every shift conv through the
  shift-and-concatenate + cuDNN conv that the JAX package computes in
  XLA on this path: it takes float32 and has a backward, where K1 takes
  bf16 and has none.

State is a dict of tensors with the JAX package's layout; its frame
counter "t" is a Python int, so masks and ring offsets are decided on
the host and no step waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import conv2d, pixel_shuffle, relu6
from ..ops import tsm_conv as tsm
from .torch_import import conv_from_torch, conv_to_torch, cpu_state_dict, subdict, to_tensors

__all__ = [
    "BSVDConfig", "BSVD_32", "BSVD_64", "SHIFT_NUM", "SHIFT_CONV_ROUTES", "init_params", "from_torch",
    "to_torch", "from_jax", "apply_single", "init_stream_state", "stream_step", "denoise_clip",
    "init_chunk_state", "chunk_step", "ring_to_fifo_state", "state_from_jax", "state_to_numpy",
]


class BSVDConfig(NamedTuple):
    chns: tuple[int, int, int] = (32, 64, 128)
    mid_ch: int = 32
    in_ch: int = 4       # RGB + noise map
    out_ch: int = 3
    interm_ch: int = 30
    act: str = "relu6"   # production config uses relu6, norm='none'


BSVD_32 = BSVDConfig()
BSVD_64 = BSVDConfig(chns=(64, 128, 256), mid_ch=64, interm_ch=64)

SHIFT_NUM = 16  # buffered convs in temp1+temp2 == reference count_shift()

# chunk_step's routes for the temporal-shift convs, to the function of
# ops/tsm_conv.py each takes (looked up at the call): "kernel" = K1's
# wrapper (the kernel on a CUDA tensor) at the widths K1 is built for,
# "library" = its plain version (shift-and-concatenate + conv2d) on any
# device, which "kernel" also takes at any other width
SHIFT_CONV_ROUTES = {"kernel": "tsm_conv", "library": "tsm_conv_plain"}

# ring-buffer depths: buffered convs between push and pop inside a DenBlock
_SKIP3_DEPTH = 4   # downc1 (2) + upc2 (2)
_SKIP12_DEPTH = 8  # downc0..upc1


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu6":
        return relu6(x)
    if kind == "relu":
        return torch.clamp(x, min=0)
    raise ValueError(kind)


# ---------------------------------------------------------------- params


def _init_denblock(g: torch.Generator, in_ch: int, out_ch: int, cfg: BSVDConfig) -> dict:
    c0, c1, c2 = cfg.chns

    def conv(i, o):
        w = torch.randn((3, 3, i, o), generator=g) * np.sqrt(2.0 / (i * 9))
        return {"w": w, "b": torch.zeros(o)}

    def mem(c):
        return {"c1": conv(c, c), "c2": conv(c, c)}

    return {
        "inc0": conv(in_ch, cfg.interm_ch), "inc1": conv(cfg.interm_ch, c0),
        "down0": conv(c0, c1), "down0_mem": mem(c1),
        "down1": conv(c1, c2), "down1_mem": mem(c2),
        "up2_mem": mem(c2), "up2": conv(c2, c1 * 4),
        "up1_mem": mem(c1), "up1": conv(c1, c0 * 4),
        "outc0": conv(c0, c0), "outc1": conv(c0, out_ch),
    }


def init_params(
    generator: torch.Generator,
    cfg: BSVDConfig = BSVD_32,
    device: str | torch.device = "cpu",
) -> dict:
    """He-normal random weights drawn from `generator`."""
    return to_tensors({
        "temp1": _init_denblock(generator, cfg.in_ch, cfg.mid_ch, cfg),
        "temp2": _init_denblock(generator, cfg.mid_ch, cfg.out_ch, cfg),
    }, device)


# a DenBlock's convs -> their prefix in the reference checkpoint
# (model.py:276-306), in the pytree's order: down blocks store [conv,
# norm, act, memconv], so a memconv's keys live under convblock.3 with
# `net.` as the conv's name (its c1 and c2); up blocks are [memconv,
# conv] -> convblock.{0,1}
_DENBLOCK_KEYS = {
    "inc0": "inc.convblock.0.", "inc1": "inc.convblock.3.",
    "down0": "downc0.convblock.0.", "down0_mem": "downc0.convblock.3.",
    "down1": "downc1.convblock.0.", "down1_mem": "downc1.convblock.3.",
    "up2_mem": "upc2.convblock.0.", "up2": "upc2.convblock.1.",
    "up1_mem": "upc1.convblock.0.", "up1": "upc1.convblock.1.",
    "outc0": "outc.convblock.0.", "outc1": "outc.convblock.3.",
}


def _denblock_from_torch(sd: dict, cfg: BSVDConfig) -> dict:
    return {
        name: ({"c1": conv_from_torch(sd, prefix + "c1.net."), "c2": conv_from_torch(sd, prefix + "c2.net.")}
               if name.endswith("_mem") else conv_from_torch(sd, prefix))
        for name, prefix in _DENBLOCK_KEYS.items()
    }


def from_torch(
    sd: dict[str, np.ndarray],
    cfg: BSVDConfig = BSVD_32,
    device: str | torch.device = "cpu",
) -> dict:
    """Split the two-net checkpoint (reference model.py:487-499)."""
    base = "module.base_model." if any(k.startswith("module.") for k in sd) else "base_model."
    return to_tensors({
        "temp1": _denblock_from_torch(subdict(sd, base + "nets_list.0."), cfg),
        "temp2": _denblock_from_torch(subdict(sd, base + "nets_list.1."), cfg),
    }, device)


def to_torch(params: dict) -> dict[str, torch.Tensor]:
    """The inverse of from_torch: a CPU float32 state dict in the
    reference's two-net key layout (`base_model.nets_list.{0,1}.`)."""
    sd = {}
    for i, net in enumerate(("temp1", "temp2")):
        base = f"base_model.nets_list.{i}."
        for name, prefix in _DENBLOCK_KEYS.items():
            if name.endswith("_mem"):
                sd.update(conv_to_torch(params[net][name]["c1"], base + prefix + "c1.net."))
                sd.update(conv_to_torch(params[net][name]["c2"], base + prefix + "c2.net."))
            else:
                sd.update(conv_to_torch(params[net][name], base + prefix))
    return cpu_state_dict(sd)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's BSVD pytree (leaves as numpy arrays) as tensors."""
    return to_tensors(np_params, device)


# ------------------------------------------------------- single-frame path


def _conv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return conv2d(x, p["w"], p.get("b"), stride=stride, padding=1)


def _shift_conv_single(p: dict, x: torch.Tensor) -> torch.Tensor:
    """A shift conv with empty temporal neighbours: the first 2*fold
    input channels are zeros."""
    fold = x.shape[-1] // 8
    inp = torch.cat([torch.zeros_like(x[..., : 2 * fold]), x[..., 2 * fold :]], dim=-1)
    return _conv(p, inp)


def _denblock_single(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    def a(v):
        return _act(v, act)

    skip1 = x[..., :3]
    x0 = a(_conv(p["inc1"], a(_conv(p["inc0"], x))))
    # down 0 (reference DownBlock: conv/2 -> act -> memconv)
    x1 = a(_conv(p["down0"], x0, stride=2))
    x1 = a(_shift_conv_single(p["down0_mem"]["c1"], x1))
    x1 = a(_shift_conv_single(p["down0_mem"]["c2"], x1))
    # down 1
    x2 = a(_conv(p["down1"], x1, stride=2))
    x2 = a(_shift_conv_single(p["down1_mem"]["c1"], x2))
    x2 = a(_shift_conv_single(p["down1_mem"]["c2"], x2))
    # up 2
    u2 = a(_shift_conv_single(p["up2_mem"]["c1"], x2))
    u2 = a(_shift_conv_single(p["up2_mem"]["c2"], u2))
    u2 = pixel_shuffle(_conv(p["up2"], u2), 2)
    # up 1
    u1 = a(_shift_conv_single(p["up1_mem"]["c1"], u2 + x1))
    u1 = a(_shift_conv_single(p["up1_mem"]["c2"], u1))
    u1 = pixel_shuffle(_conv(p["up1"], u1), 2)
    # out
    y = _conv(p["outc1"], a(_conv(p["outc0"], u1 + x0)))
    return _residual3(y, skip1)


def apply_single(params: dict, x: torch.Tensor, *, cfg: BSVDConfig = BSVD_32) -> torch.Tensor:
    """Denoise one frame as the reference production path does (fresh
    state and a full flush every call): x (N, H, W, in_ch) ->
    (N, H, W, out_ch).  H and W must be multiples of 4."""
    return _denblock_single(params["temp2"], _denblock_single(params["temp1"], x, cfg.act), cfg.act)


# ------------------------------------------------------------------ state


def _zeros_mem(n, h, w, c, dtype, device):
    def z(ch):
        return torch.zeros((n, h, w, ch), dtype=dtype, device=device)

    return {"c1": {"left": z(c // 8), "center": z(c)}, "c2": {"left": z(c // 8), "center": z(c)}}


def _init_denblock_state(n, h, w, cfg: BSVDConfig, dtype, device) -> dict:
    c0, c1, c2 = cfg.chns
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return {
        "skip1": torch.zeros((_SKIP12_DEPTH, n, h, w, 3), dtype=dtype, device=device),
        "skip2": torch.zeros((_SKIP12_DEPTH, n, h, w, c0), dtype=dtype, device=device),
        "skip3": torch.zeros((_SKIP3_DEPTH, n, h2, w2, c1), dtype=dtype, device=device),
        "down0": _zeros_mem(n, h2, w2, c1, dtype, device),
        "down1": _zeros_mem(n, h4, w4, c2, dtype, device),
        "up2": _zeros_mem(n, h4, w4, c2, dtype, device),
        "up1": _zeros_mem(n, h2, w2, c1, dtype, device),
    }


def init_stream_state(
    n: int, h: int, w: int, cfg: BSVDConfig = BSVD_32,
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cpu",
) -> dict:
    """Fresh state for stream_step (all buffers zero, t=0), with the JAX
    package's layout; chunk_step starts from the same zero state
    (init_chunk_state).  H and W must be multiples of 4 (two stride-2
    stages)."""
    return {
        "t": 0,
        "temp1": _init_denblock_state(n, h, w, cfg, dtype, device),
        "temp2": _init_denblock_state(n, h, w, cfg, dtype, device),
    }


def init_chunk_state(
    n: int, h: int, w: int, cfg: BSVDConfig = BSVD_32,
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cpu",
) -> dict:
    """Fresh carry for chunk_step (the JAX package's name for it): the
    same zero state as init_stream_state, whose skip buffers chunk_step
    runs as FIFOs."""
    return init_stream_state(n, h, w, cfg, dtype, device)


def state_from_jax(np_state: dict, device: str | torch.device = "cpu") -> dict:
    """A JAX stream state (leaves as numpy arrays) as the port's state;
    buffer order (FIFO or warm ring) is kept as it is."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(a.copy()).to(device)

    return {"t": int(np.asarray(np_state["t"])), **{k: conv(np_state[k]) for k in ("temp1", "temp2")}}


def state_to_numpy(state: dict) -> dict:
    """The port's state with numpy leaves (t as an int32 scalar), in the
    JAX package's layout, for comparison."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tree.detach().float().cpu().numpy()

    return {"t": np.int32(state["t"]), **{k: conv(state[k]) for k in ("temp1", "temp2")}}


# ----------------------------------------------------------- streaming path


def _bibuffer_step(p, st, x, t, d, t_end, act):
    """One shift conv on one frame.  st = {'left': (..., fold), 'center':
    x-like}; t: the global step; d: this conv's pipeline depth (its first
    real input arrives at step d); t_end: the end of its real-input
    window (T + d), or None for an endless stream.  The state takes x
    from step d on and its fold slice from step d + 1 on, so warm-up
    garbage never enters it."""
    fold = x.shape[-1] // 8
    if t_end is not None and t >= t_end:
        x = torch.zeros_like(x)
    inp = torch.cat([x[..., :fold], st["left"], st["center"][..., 2 * fold :]], dim=-1)
    y = _act(_conv(p, inp), act)
    new_left = st["center"][..., fold : 2 * fold] if t >= d + 1 else st["left"]
    new_center = x if t >= d else st["center"]
    return y, {"left": new_left, "center": new_center}


def _mem_step(p, st, x, t, d, t_end, act):
    y, s1 = _bibuffer_step(p["c1"], st["c1"], x, t, d, t_end, act)
    y, s2 = _bibuffer_step(p["c2"], st["c2"], y, t, d + 1, None if t_end is None else t_end + 1, act)
    return y, {"c1": s1, "c2": s2}


def _ring_pop_push(buf: torch.Tensor, val: torch.Tensor, t: int):
    """Read slot t % depth of a ring, then write val there: (popped, new
    ring).  The new ring is a copy, so the state passed in stays as it
    was."""
    slot = t % buf.shape[0]
    new = buf.clone()
    new[slot] = val
    return buf[slot], new


def _denblock_step(p, st, x, t, d0, t_end0, act):
    """One streaming step of a DenBlock.  d0: the depth of its first
    shift conv; t_end0: that conv's input-window end (or None)."""

    def a(v):
        return _act(v, act)

    def te(offset):
        return None if t_end0 is None else t_end0 + offset

    skip1, st_skip1 = _ring_pop_push(st["skip1"], x[..., :3], t)
    x0 = a(_conv(p["inc1"], a(_conv(p["inc0"], x))))
    skip2, st_skip2 = _ring_pop_push(st["skip2"], x0, t)

    x1 = a(_conv(p["down0"], x0, stride=2))
    x1, st_d0 = _mem_step(p["down0_mem"], st["down0"], x1, t, d0, te(0), act)
    skip3, st_skip3 = _ring_pop_push(st["skip3"], x1, t)

    x2 = a(_conv(p["down1"], x1, stride=2))
    x2, st_d1 = _mem_step(p["down1_mem"], st["down1"], x2, t, d0 + 2, te(2), act)

    u2, st_u2 = _mem_step(p["up2_mem"], st["up2"], x2, t, d0 + 4, te(4), act)
    u2 = pixel_shuffle(_conv(p["up2"], u2), 2)

    u1, st_u1 = _mem_step(p["up1_mem"], st["up1"], u2 + skip3, t, d0 + 6, te(6), act)
    u1 = pixel_shuffle(_conv(p["up1"], u1), 2)

    y = _conv(p["outc1"], a(_conv(p["outc0"], u1 + skip2)))
    y = _residual3(y, skip1)
    new_st = {
        "skip1": st_skip1, "skip2": st_skip2, "skip3": st_skip3,
        "down0": st_d0, "down1": st_d1, "up2": st_u2, "up1": st_u1,
    }
    return y, new_st


def stream_step(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    cfg: BSVDConfig = BSVD_32,
    t_end: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Feed one frame (N, H, W, in_ch); returns (y, new_state).  y is the
    denoised frame from SHIFT_NUM steps ago, valid once state['t'] >=
    SHIFT_NUM.  Endless live streams leave t_end=None; to flush a
    T-frame clip, keep stepping with zero frames and t_end=T.  The state
    (init_stream_state) runs its skip buffers as rings: it must not be
    moved between stream_step and chunk_step mid-stream."""
    t = state["t"]
    mid, st1 = _denblock_step(params["temp1"], state["temp1"], x, t, 0, t_end, cfg.act)
    y, st2 = _denblock_step(params["temp2"], state["temp2"], mid, t, 8, None if t_end is None else t_end + 8, cfg.act)
    return y, {"t": t + 1, "temp1": st1, "temp2": st2}


def denoise_clip(params: dict, frames: torch.Tensor, *, cfg: BSVDConfig = BSVD_32) -> torch.Tensor:
    """Denoise a whole clip one frame a step, as the reference's
    streaming_forward does over the same sequence (model.py:526-580):
    frames (T, N, H, W, in_ch) -> (T, N, H, W, out_ch).  Runs T +
    SHIFT_NUM steps (the flush included) and keeps outputs [SHIFT_NUM:)."""
    t_total, n, h, w, _ = frames.shape
    state = init_stream_state(n, h, w, cfg, frames.dtype, frames.device)
    zero = torch.zeros_like(frames[0])
    outs = []
    for i in range(t_total + SHIFT_NUM):
        y, state = stream_step(params, state, frames[i] if i < t_total else zero, cfg=cfg, t_end=t_total)
        if i >= SHIFT_NUM:
            outs.append(y)
    return torch.stack(outs)


# ------------------------------------------------------------ chunked path


def _window_mask(x: torch.Tensor, first_idx: int, t_end: int | None) -> torch.Tensor:
    """Zero chunk positions whose global frame index falls outside
    [0, t_end): below 0 = warm-up garbage must not reach taps/carries;
    >= t_end = the reference's flush protocol feeds zeros at every level."""
    bad = [
        i for i in range(x.shape[0])
        if first_idx + i < 0 or (t_end is not None and first_idx + i >= t_end)
    ]
    if not bad:
        return x
    x = x.clone()
    for i in bad:
        x[i] = 0
    return x


def _shift_conv_fn(route: str, c: int):
    """The function of ops/tsm_conv.py that a shift conv of C channels
    takes on `route`, decided by the width before any launch: "kernel"
    is K1's wrapper where K1 is built for C (tsm.KERNEL_CHANNELS) and the
    shift-and-concatenate conv elsewhere, as the JAX package routes every
    shape that its kernel does not take."""
    if route == "kernel" and c not in tsm.KERNEL_CHANNELS:
        return tsm.tsm_conv_plain
    return getattr(tsm, SHIFT_CONV_ROUTES[route])


def _shift_conv_chunk(p: dict, st: dict, x: torch.Tensor, act: str, conv=None):
    """One temporal-shift conv over a chunk x (T, N, H, W, C) with carry
    st = {'left': x_{a-2}[..., fold:2fold], 'center': x_{a-1}}: output j
    is aligned to frame a-1+j.  `conv` is K1's wrapper (the default) or
    its plain version.  Returns (y, new carry)."""
    t = x.shape[0]
    fold = x.shape[-1] // 8
    y = (conv or tsm.tsm_conv)(x, st["center"], st["left"], p["w"], p.get("b"), act=act)
    new_left = x[-2, ..., fold : 2 * fold] if t >= 2 else st["center"][..., fold : 2 * fold]
    return y, {"left": new_left.contiguous(), "center": x[-1]}


def _pair_chunk(p, st, x, act):
    """Both shift convs of a mem block through K2's wrapper (warm chunks,
    T >= 2): the same outputs and carries as two _shift_conv_chunk calls."""
    fold = x.shape[-1] // 8
    y2, y1_last2 = tsm.tsm_conv_pair(
        x, st["c1"]["center"], st["c1"]["left"], st["c2"]["center"], st["c2"]["left"],
        p["c1"]["w"], p["c1"].get("b"), p["c2"]["w"], p["c2"].get("b"), act=act)
    new_c1 = {"left": x[-2, ..., fold : 2 * fold].contiguous(), "center": x[-1]}
    new_c2 = {"left": y1_last2[0, ..., fold : 2 * fold].contiguous(), "center": y1_last2[1]}
    return y2, {"c1": new_c1, "c2": new_c2}


def _mem_chunk(p, st, x, act, first_idx, t_end, warm, tsm_pair, route):
    """A mem block's two shift convs on `route` (_shift_conv_fn); cold and
    flush chunks zero the conv inputs outside each conv's frame window
    (warm chunks skip it).  tsm_pair runs a warm chunk of T >= 2 frames
    on K1's route through K2; cold and flush chunks keep K1, since a
    window mask lies between their convs."""
    conv = _shift_conv_fn(route, x.shape[-1])
    if warm and tsm_pair and x.shape[0] >= 2 and conv is tsm.tsm_conv:
        return _pair_chunk(p, st, x, act)
    if not warm:
        x = _window_mask(x, first_idx, t_end)
    y, s1 = _shift_conv_chunk(p["c1"], st["c1"], x, act, conv)
    if not warm:
        y = _window_mask(y, first_idx - 1, t_end)
    y, s2 = _shift_conv_chunk(p["c2"], st["c2"], y, act, conv)
    return y, {"c1": s1, "c2": s2}


def _conv_batched(p, x, act=None, stride=1):
    t, n, h, w, c = x.shape
    y = conv2d(x.reshape(t * n, h, w, c), p["w"], p.get("b"), stride=stride, padding=1)
    if act is not None:
        y = _act(y, act)
    return y.reshape(t, n, *y.shape[1:])


def _ps_batched(x: torch.Tensor, r: int) -> torch.Tensor:
    t, n, h, w, c = x.shape
    y = pixel_shuffle(x.reshape(t * n, h, w, c), r)
    return y.reshape(t, n, *y.shape[1:])


def _fifo(carry: torch.Tensor, chunk: torch.Tensor, base: int | None = None, inplace: bool = False):
    """Skip FIFO: carry holds the D frames before the chunk.  Returns the
    chunk-length window aligned D frames back, the new carry, and a push
    left to the caller (None when the push is done).

    base (global index of chunk[0]) switches to a RING layout: frame f
    lives at slot f % D, and pop/push are T-frame slices at base % D.
    Only valid when T divides D and base % D is T-aligned; chunk_step
    passes base only on warm steps, where the service's warm switch
    guarantees both.  The push writes a copy of the carry, so the state
    passed in stays as it was; with inplace, the ring is the carry itself
    and the push is returned: the pop is a view of the slots it
    overwrites, so the caller runs it after the pop's last use."""
    d = carry.shape[0]
    t = chunk.shape[0]
    if base is not None and d % t == 0:
        off = base % d
        pop = carry[off : off + t]
        if inplace:
            return pop, carry, lambda: carry[off : off + t].copy_(chunk)
        new = carry.clone()
        new[off : off + t] = chunk
        return pop, new, None
    full = torch.cat([carry, chunk], dim=0)
    return full[:t], full[t : t + d], None


def _residual3(y: torch.Tensor, skip1: torch.Tensor) -> torch.Tensor:
    """out[..., :3] = skip1 - y[..., :3], rest passthrough (the DenBlock
    residual, reference model.py:421-424)."""
    if y.shape[-1] == 3:
        return skip1 - y
    return torch.cat([skip1 - y[..., :3], y[..., 3:]], dim=-1)


def ring_to_fifo_state(state: dict, cfg: BSVDConfig = BSVD_32) -> dict:
    """Convert a state whose skip1/skip2 buffers are in RING order (left
    by warm chunk_step calls: frame f at slot f % D) back to the FIFO
    order the cold/flush steps expect (slot i = frame t - D + i).  Call
    once before flushing a stream that ran warm chunks."""

    def fix(block):
        d = block["skip1"].shape[0]
        r = state["t"] % d

        def roll(buf):
            return torch.cat([buf[r:], buf[:r]], dim=0)

        return {**block, "skip1": roll(block["skip1"]), "skip2": roll(block["skip2"])}

    return {**state, "temp1": fix(state["temp1"]), "temp2": fix(state["temp2"])}


def _denblock_chunk(p, st, x, act, base, t_end, warm, tsm_pair, inplace, route):
    """One DenBlock over a chunk.  x: (T, N, H, W, in_ch) for frames
    [base, base+T); returns output frames [base-8, base+T-8)."""
    rb = base if warm else None  # ring FIFOs on warm steps only
    skip1, st_s1, push1 = _fifo(st["skip1"], x[..., :3], rb, inplace)
    x0 = _conv_batched(p["inc1"], _conv_batched(p["inc0"], x, act), act)
    skip2, st_s2, push2 = _fifo(st["skip2"], x0, rb, inplace)
    x1 = _conv_batched(p["down0"], x0, act, stride=2)
    x1, st_d0 = _mem_chunk(p["down0_mem"], st["down0"], x1, act, base, t_end, warm, tsm_pair, route)
    skip3, st_s3, _ = _fifo(st["skip3"], x1)  # x1 frames [base-2, ...)
    x2 = _conv_batched(p["down1"], x1, act, stride=2)
    x2, st_d1 = _mem_chunk(p["down1_mem"], st["down1"], x2, act, base - 2, t_end, warm, tsm_pair, route)
    u2, st_u2 = _mem_chunk(p["up2_mem"], st["up2"], x2, act, base - 4, t_end, warm, tsm_pair, route)
    u2 = _ps_batched(_conv_batched(p["up2"], u2), 2)
    u1, st_u1 = _mem_chunk(p["up1_mem"], st["up1"], u2 + skip3, act, base - 6, t_end, warm, tsm_pair, route)
    u1 = _ps_batched(_conv_batched(p["up1"], u1), 2)
    y = _conv_batched(p["outc1"], _conv_batched(p["outc0"], u1 + skip2, act))
    y = _residual3(y, skip1)
    # the pops are used: the in-place pushes may overwrite their slots now
    for push in (push1, push2):
        if push is not None:
            push()
    new_st = {
        "skip1": st_s1, "skip2": st_s2, "skip3": st_s3,
        "down0": st_d0, "down1": st_d1, "up2": st_u2, "up1": st_u1,
    }
    return y, new_st


def chunk_step(
    params: dict,
    state: dict,
    frames: torch.Tensor,
    *,
    cfg: BSVDConfig = BSVD_32,
    t_end: int | None = None,
    warm: bool = False,
    tsm_pair: bool = False,
    inplace: bool = False,
    shift_conv: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """Denoise a chunk of T consecutive frames in one layer-major pass.

    frames: (T, N, H, W, in_ch) -> ((T, N, H, W, out_ch), new_state).
    Output j is the denoised result for input frame
    state['t'] + j - SHIFT_NUM (16 frames of inherent lookahead; the
    first SHIFT_NUM outputs of a fresh stream are pre-valid garbage).
    To flush a T_clip-frame clip, follow its frames with SHIFT_NUM zero
    frames and t_end=T_clip.  Endless live streams leave t_end=None.

    warm=True is the steady-state live step: the warm-up window masks
    are skipped (valid once state['t'] >= 15 and t_end is None) and the
    skip1/skip2 FIFOs run as rings when T divides 8, which requires the
    first warm call at state['t'] % 8 == 0 and the same T after it.  The
    resulting state is in ring order: pass it through
    ring_to_fifo_state before a cold or flush step.

    tsm_pair=True runs each mem block of a warm chunk with T >= 2 through
    ops/tsm_conv.py::tsm_conv_pair (K2) in place of two tsm_conv calls:
    the same function and, on the card, the same two K1 launches.  Cold
    and flush chunks ignore it.

    inplace=True lets a warm step write the T new frames into the
    skip1/skip2 rings of `state` itself instead of into a copy of each
    D-frame ring: the same outputs and state, bit for bit, but the state
    passed in is consumed, so only its owner (the service, which threads
    one state through its steps) may ask for it.  Cold and flush chunks
    ignore it.

    shift_conv picks the route of every temporal-shift conv (a key of
    SHIFT_CONV_ROUTES): "kernel", the default of every serving caller,
    is K1's wrapper at the widths K1 is built for (C in
    tsm.KERNEL_CHANNELS), which launches the kernel on a CUDA tensor
    (bf16 only) or raises, and the shift-and-concatenate conv at any
    other width (BSVD-64's C=256); "library" is the shift-and-concatenate
    + conv2d at every width, which training asks for (float32, with a
    backward; tsm_pair is then ignored)."""
    if warm and t_end is not None:
        raise ValueError("warm chunk_step is live-stream only (t_end=None)")
    if shift_conv not in SHIFT_CONV_ROUTES:
        raise ValueError(f"shift_conv must be one of {sorted(SHIFT_CONV_ROUTES)}, got {shift_conv!r}")
    n0 = state["t"]
    mid, st1 = _denblock_chunk(params["temp1"], state["temp1"], frames, cfg.act, n0, t_end, warm,
                               tsm_pair, inplace, shift_conv)
    y, st2 = _denblock_chunk(params["temp2"], state["temp2"], mid, cfg.act, n0 - 8, t_end, warm,
                             tsm_pair, inplace, shift_conv)
    return y, {"t": n0 + frames.shape[0], "temp1": st1, "temp2": st2}
