"""The production upscale compute steps on tensors (counterpart of the
JAX package's upscale/steps.py).

    uint8 NHWC -> /255 -> area-resize to lr_shape -> [BSVD denoise ->
    sharpen + 0.8 blend] -> SR model -> [HR sharpen] -> color matching
    -> clamp -> resize to output_shape -> uint8 (or yuv420p) NHWC

and the frame-recurrent EGVSR path, which threads its (lr_prev, hr_prev)
state through each call:

    uint8 NHWC -> /255 -> area-resize to lr_shape -> FRNet step -> clamp
    -> resize to output_shape -> uint8 (or yuv420p) NHWC

Every function takes and returns tensors on one device and runs
eagerly; the services call them through jit_cache.ShapeCache, which
replays one CUDA graph per input signature on the card.  The denoise
path threads BSVD's streaming state (a dict) through each call.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models import bsvd, egvsr
from ..ops import (
    global_color_match,
    local_color_match,
    resize,
    sharpen,
    to_float,
    to_uint8,
    to_yuv420,
)

__all__ = [
    "UpscaleSpec",
    "upscale_multi",
    "upscale_single_denoise",
    "init_denoise_state",
    "upscale_batch_denoise",
    "flush_batch_denoise",
    "egvsr_upscale_step",
    "egvsr_upscale_chunk",
]


class UpscaleSpec(NamedTuple):
    """Static configuration of one upscale step."""

    lr_shape: tuple[int, int] = (720, 1280)      # lr_level table, levels.py
    output_shape: tuple[int, int] | None = (1440, 2560)
    scale: int = 4
    lr_hr_resize: bool = True                     # fsrcnn_upscaler.py:173,223
    denoise_rate: float = 1.0
    denoise_opacity: float = 0.8                  # fsrcnn_upscaler.py:273
    compute_dtype: torch.dtype = torch.bfloat16   # reference: fp16 TRT + amp
    pix_fmt: str = "rgb24"                        # or 'yuv420p' (ops.to_yuv420)


def _emit(hr: torch.Tensor, spec: UpscaleSpec) -> torch.Tensor:
    """Final uint8 emission in the spec's output pixel format."""
    if spec.pix_fmt == "yuv420p":
        return to_yuv420(hr)
    return to_uint8(hr)


def _resize_to_output(hr: torch.Tensor, spec: UpscaleSpec) -> torch.Tensor:
    """Final resize to output_shape (bicubic, the reference's effective
    branch, fsrcnn_upscaler.py:224,317)."""
    if spec.output_shape is None or hr.shape[-3:-1] == tuple(spec.output_shape):
        return hr
    return resize(hr, spec.output_shape, "bicubic")


def upscale_multi(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    sr_params: Any,
    frames: torch.Tensor,
    spec: UpscaleSpec,
) -> torch.Tensor:
    """Batched path without denoise (reference upscale_multi, :168-233).

    frames: (N, H, W, 3) uint8 -> (N, OH, OW, 3) uint8.
    `sr_apply(params, x)` maps (N, h, w, 3) [0,1] -> (N, h*s, w*s, 3)."""
    hr, lr_before = _multi_local(sr_apply, sr_params, frames, spec)
    return _multi_finish(hr, lr_before, spec)


def _multi_local(sr_apply, sr_params, frames: torch.Tensor, spec: UpscaleSpec):
    """upscale_multi up to its colour match, the part that reads only a
    pixel's neighbourhood: (SR output, the LR frames it matches)."""
    img = to_float(frames)
    lr = img
    h, w = img.shape[-3], img.shape[-2]
    if spec.lr_hr_resize and (h > spec.lr_shape[0] or w > spec.lr_shape[1]):
        lr = resize(img, spec.lr_shape, "area")
    return sr_apply(sr_params, lr.to(spec.compute_dtype)), lr


def _multi_finish(hr, lr_before, spec: UpscaleSpec, stats=None, full_hw=None) -> torch.Tensor:
    """upscale_multi from its colour match on: the global match (with the
    per-image statistics `stats` where a caller computed them over a
    whole frame that `hr` is a part of, ops.global_color_match), the
    local match (`full_hw`: that whole frame's HR size), clamp, output
    resize and emission."""
    hr = global_color_match(hr, lr_before, stats)
    hr = local_color_match(hr, lr_before, full_hw=full_hw)
    hr = torch.clamp(hr, 0.0, 1.0)
    if spec.lr_hr_resize:
        hr = _resize_to_output(hr, spec)
    return _emit(hr, spec)


def _ceil4(v: int) -> int:
    return -(-v // 4) * 4


def init_denoise_state(
    n: int,
    spec: UpscaleSpec,
    cfg: bsvd.BSVDConfig = bsvd.BSVD_32,
    dtype: torch.dtype | None = None,
    device: str | torch.device = "cpu",
) -> dict:
    """Fresh BSVD streaming state in the step's compute dtype, with dims
    rounded up to multiples of 4 (two stride-2 stages); the steps pad and
    crop accordingly (the 630-row rung)."""
    h, w = _ceil4(spec.lr_shape[0]), _ceil4(spec.lr_shape[1])
    return bsvd.init_stream_state(n, h, w, cfg, dtype or spec.compute_dtype, device)


def _bsvd_pad(x: torch.Tensor, spec: UpscaleSpec) -> torch.Tensor:
    """Edge-pad (N, H, W, C) up to the /4 state size."""
    h, w = spec.lr_shape
    ph, pw = _ceil4(h) - h, _ceil4(w) - w
    if ph:
        x = torch.cat([x, x[:, -1:].expand(-1, ph, -1, -1)], dim=1)
    if pw:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
    return x


def _bsvd_crop(y: torch.Tensor, spec: UpscaleSpec) -> torch.Tensor:
    h, w = spec.lr_shape
    return y[:, :h, :w, :]


def _noise_value(idx: int, spec: UpscaleSpec, dtype: torch.dtype) -> float:
    """Noise-map level: 0.05 at global frame 0, 0.1*denoise_rate after
    (reference fsrcnn_upscaler.py:262,269), rounded as float32 and then
    to the state dtype."""
    v = 0.05 if idx == 0 else 0.1 * spec.denoise_rate
    return torch.tensor(v, dtype=torch.float32).to(dtype).item()


def upscale_single_denoise(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    params: dict,
    state: dict,
    frame: torch.Tensor,
    spec: UpscaleSpec,
    cfg: bsvd.BSVDConfig = bsvd.BSVD_32,
) -> tuple[torch.Tensor, dict]:
    """Denoise-enabled per-frame path (reference upscale_single,
    :235-326): the reference's own dataflow, one frame a call through
    bsvd.stream_step, which launches no kernel.

    frame: (N, H, W, 3) uint8; params: {"sr": ..., "denoise": ...};
    state: BSVD stream state from init_denoise_state.
    Returns (out uint8 (N, OH, OW, 3), new_state).

    A constant noise map of 0.1*denoise_rate is the 4th input channel
    (0.05 on the very first frame, :262,269); the denoised frame, SHIFT_NUM
    frames behind the current one, is sharpened (2e-5), clamped and
    blended at 0.8 opacity with the current pre-denoise frame
    (:279-281); SR runs on the blend, then an HR sharpen (7e-5,
    :298-299) and the global color match only (:302-313).  The LR frame
    is edge-padded to the /4 state size for BSVD and cropped back."""
    img = to_float(frame)
    lr = resize(img, spec.lr_shape, "area")
    lr_before = lr
    state_dtype = state["temp1"]["skip1"].dtype
    lr_p = _bsvd_pad(lr, spec)
    noise = torch.full(lr_p.shape[:3] + (1,), _noise_value(state["t"], spec, state_dtype),
                       dtype=state_dtype, device=lr.device)
    x4 = torch.cat([lr_p.to(state_dtype), noise], dim=-1)
    den, new_state = bsvd.stream_step(params["denoise"], state, x4, cfg=cfg)
    return _denoise_postproc(sr_apply, params, den, lr, lr_before, spec), new_state


def upscale_batch_denoise(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    params: dict,
    state: dict,
    frames: torch.Tensor,
    spec: UpscaleSpec,
    cfg: bsvd.BSVDConfig = bsvd.BSVD_32,
    warm: bool = False,
    sr_sub_batch: int | None = None,
    tsm_pair: bool = False,
    inplace: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Micro-batched denoise path: the micro-batch runs through BSVD in
    one layer-major chunk_step, then the SR stage and color matching run
    batched (in sub-batches of sr_sub_batch when T is a larger multiple).

    frames: (T, H, W, 3) uint8 -> ((T, OH, OW, 3) uint8, new_state).
    Output slot j blends input j's LR frame with the denoised frame
    SHIFT_NUM frames behind it (the reference production denoiser's
    pipeline delay).  tsm_pair: BSVD's warm mem blocks through K2;
    inplace: a warm step updates the state's skip rings in place, which
    consumes the state passed in (both bsvd.chunk_step)."""
    den, lr, new_state = _denoise_front(params, state, frames, spec, cfg, warm=warm, tsm_pair=tsm_pair,
                                        inplace=inplace)
    outs = [_denoise_postproc(sr_apply, params, den[sl], lr[sl], lr[sl], spec)
            for sl in _sub_batches(lr.shape[0], sr_sub_batch)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), new_state


def _denoise_front(params, state, frames, spec: UpscaleSpec, cfg: bsvd.BSVDConfig, **chunk_kw):
    """upscale_batch_denoise's BSVD chunk: (denoised (T, h, w, 3) at the
    /4 state size, the LR frames, new state)."""
    img = to_float(frames)
    lr = resize(img, spec.lr_shape, "area")
    t = lr.shape[0]
    state_dtype = state["temp1"]["skip1"].dtype

    lr_p = _bsvd_pad(lr, spec)
    h, w = lr_p.shape[1:3]
    noise = torch.stack([
        torch.full((1, h, w, 1), _noise_value(state["t"] + i, spec, state_dtype),
                   dtype=state_dtype, device=lr.device)
        for i in range(t)
    ])
    x4 = torch.cat([lr_p[:, None].to(state_dtype), noise], dim=-1)
    den, new_state = bsvd.chunk_step(params["denoise"], state, x4, cfg=cfg, **chunk_kw)
    return den[:, 0], lr, new_state


def _warm_index(t: int, ring: int, n: int) -> int:
    """The frame index that keys a warm step of n frames at frame t: the
    warm step reads its index only through the skip rings' slot (t %
    ring, where n divides the ring; a chunk that does not runs its skips
    as FIFOs) and, for the noise level, whether it is frame 0, which a
    warm step never is.  So the steps at t and at this index are the
    same work on the same values."""
    return bsvd.SHIFT_NUM + (t % ring if ring % n == 0 else 0)


def _sub_batches(t: int, sr_sub_batch: int | None) -> list[slice]:
    """The SR tail's sub-batches of a T-frame chunk: sr_sub_batch frames
    each when T is a larger multiple of it, else the whole chunk."""
    if sr_sub_batch and t > sr_sub_batch and t % sr_sub_batch == 0:
        return [slice(i, i + sr_sub_batch) for i in range(0, t, sr_sub_batch)]
    return [slice(0, t)]


def _denoise_postproc(sr_apply, params, den, lr, lr_before, spec: UpscaleSpec):
    """Shared tail of the denoise paths: sharpen + blend the denoised
    frames against the pre-denoise LR, SR, HR sharpen, global color
    match, output resize, uint8 (reference upscale_single :279-326).
    Runs in the compute dtype, like the reference's fp16 amp region."""
    return _denoise_finish(_denoise_local(sr_apply, params, den, lr, spec), lr_before, spec)


def _denoise_local(sr_apply, params, den, lr, spec: UpscaleSpec) -> torch.Tensor:
    """_denoise_postproc up to its colour match, the part that reads only
    a pixel's neighbourhood: the sharpened, clamped SR output."""
    den = _bsvd_crop(den, spec)
    den = torch.clamp(sharpen(den.to(spec.compute_dtype), 0.00002), 0.0, 1.0)
    lr = den * spec.denoise_opacity + (1.0 - spec.denoise_opacity) * lr

    hr = sr_apply(params["sr"], lr.to(spec.compute_dtype))
    return torch.clamp(sharpen(hr, 0.00007), 0.0, 1.0)


def _denoise_finish(hr, lr_before, spec: UpscaleSpec, stats=None) -> torch.Tensor:
    """_denoise_postproc from its global colour match on (`stats` as in
    _multi_finish): clamp, output resize and emission."""
    hr = global_color_match(hr, lr_before, stats)
    hr = torch.clamp(hr, 0.0, 1.0)
    hr = _resize_to_output(hr, spec)
    return _emit(hr, spec)


def flush_batch_denoise(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    params: dict,
    state: dict,
    lr_tail: torch.Tensor,
    t_end: int,
    spec: UpscaleSpec,
    cfg: bsvd.BSVDConfig = bsvd.BSVD_32,
) -> tuple[torch.Tensor, dict]:
    """Drain part of the SHIFT_NUM in-flight frames at end-of-stream:
    feed one chunk of T zero frames with the flush window t_end (real
    frames fed over the whole stream) and post-process the drained
    outputs against their own pre-denoise frames.

    lr_tail: (T, H, W, 3) uint8, the raw frames this chunk drains, oldest
    first (zero-filled where the caller discards the output).
    Returns ((T, OH, OW, 3) uint8, new_state)."""
    den, lr, new_state = _flush_front(params, state, lr_tail, t_end, spec, cfg)
    return _denoise_postproc(sr_apply, params, den, lr, lr, spec), new_state


def _flush_front(params, state, lr_tail, t_end: int, spec: UpscaleSpec, cfg: bsvd.BSVDConfig):
    """flush_batch_denoise's BSVD chunk of zero frames: (drained frames,
    the LR frames they blend with, new state)."""
    img = to_float(lr_tail)
    lr = resize(img, spec.lr_shape, "area")
    state_dtype = state["temp1"]["skip1"].dtype
    h, w = _ceil4(spec.lr_shape[0]), _ceil4(spec.lr_shape[1])
    zeros = torch.zeros((lr_tail.shape[0], 1, h, w, 4), dtype=state_dtype, device=lr.device)
    den, new_state = bsvd.chunk_step(params["denoise"], state, zeros, cfg=cfg, t_end=t_end)
    return den[:, 0], lr, new_state


def _egvsr_lr(frames: torch.Tensor, spec: UpscaleSpec) -> torch.Tensor:
    img = to_float(frames)
    h, w = img.shape[-3], img.shape[-2]
    if spec.lr_hr_resize and (h > spec.lr_shape[0] or w > spec.lr_shape[1]):
        img = resize(img, spec.lr_shape, "area")
    return img.to(spec.compute_dtype)


def egvsr_upscale_step(
    params: dict,
    state: tuple,
    frame: torch.Tensor,
    spec: UpscaleSpec,
    cut_threshold: float | None = None,
    cfg: egvsr.EGVSRConfig | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Frame-recurrent EGVSR path (reference egvsr_upscaler.py:145-212):
    area-resize to lr_shape, one FRNet step with the (lr_prev, hr_prev)
    carry (the HR warp through K3), clamp, resize to output_shape, uint8.
    frame: (N, H, W, 3) uint8 -> ((N, OH, OW, 3) uint8, new_state).
    cut_threshold: the scene-cut skip (egvsr.frnet_step)."""
    hr, new_state = egvsr.infer_step(
        params, state, _egvsr_lr(frame, spec),
        cfg=egvsr.DEFAULT if cfg is None else cfg, cut_threshold=cut_threshold,
    )
    hr = torch.clamp(hr.float(), 0.0, 1.0)
    return _emit(_resize_to_output(hr, spec), spec), new_state


def egvsr_upscale_chunk(
    params: dict,
    state: tuple,
    frames: torch.Tensor,
    spec: UpscaleSpec,
    cut_threshold: float | None = None,
    cfg: egvsr.EGVSRConfig | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Micro-batch EGVSR path: frames (T, H, W, 3) uint8, with the pre-
    and post-processing batched over T and FNet run once at batch T
    (egvsr.infer_chunk); only the warp + SRNet recurrence loops."""
    hr, new_state = egvsr.infer_chunk(
        params, state, _egvsr_lr(frames, spec)[:, None],
        cfg=egvsr.DEFAULT if cfg is None else cfg, cut_threshold=cut_threshold,
    )
    hr = torch.clamp(hr[:, 0].float(), 0.0, 1.0)
    return _emit(_resize_to_output(hr, spec), spec), new_state
