"""Sharded (multi-device) versions of the production serving steps
(counterpart of the JAX package's parallel/sharded.py).

One process drives every device of the mesh.  Parameters are copied to
each device once, the first time a factory's function sees them.  The
micro-batch rides the "data" axis; the width of a frame is split into
bands, one a device (parallel/_bands.py).  The port has no partitioner
to put a halo exchange before each conv, so the halo is per step: each
band runs the unchanged single-device step (its K1 and K4 launches
included) on its centre plus `halo` LR columns on each side, clipped at
the frame's edges, and crops the halo from what it emits.  With `halo`
at least the step's receptive radius (the *_radius functions below, from
the model's config), the centres equal the whole-frame step's up to
rounding.  A state leaves a call split the same way (a ShardedState);
before each call its halo columns are written again from the
neighbouring bands' centres, so they are exact at the start of every
call and chunks chain as they do on one device.

Only three things cross bands besides the halos:

- the per-image statistics of the global colour match, from the
  centres' sums and then their sums of squared deviations (two
  reductions on the mesh's first device);
- EGVSR's previous HR frame, which a flow may read anywhere: each step
  gathers it whole to every device and warps the band's columns from it
  with the plain gather warp in the frame's coordinates (the JAX factory
  also warps with the gather; K3 stays a single-device route);
- EGVSR's scene-cut test, a mean over the whole frame.

Tensors go in on any device (host frames are uploaded band by band
through pinned memory) and the outputs come back whole on the mesh's
first device.  `halo=None` gives every band the whole frame: exact for
any sr_apply, at no saving.
"""

from __future__ import annotations

from fractions import Fraction
from math import ceil, gcd
from typing import Any, Callable

import torch

from ..models import bsvd, egvsr, rrdbnet, srvgg
from ..ops import space_to_depth
from ..ops.warp import backward_warp_columns
from ..upscale.steps import (
    UpscaleSpec,
    _denoise_finish,
    _denoise_front,
    _denoise_local,
    _egvsr_lr,
    _emit,
    _flush_front,
    _multi_finish,
    _multi_local,
    _resize_to_output,
    _sub_batches,
)
from ._bands import (
    Band,
    ShardedState,
    alignment,
    band_slice,
    cols,
    gather_bands,
    gather_yuv420,
    on_device,
    put,
    replicate,
    shard_state,
    shared_stats,
    split_width,
)
from .mesh import AXES, Mesh, NamedSharding, P

__all__ = [
    "make_sharded_upscale",
    "make_sharded_denoise",
    "make_sharded_denoise_flush",
    "make_sharded_egvsr_step",
    "make_sharded_train_step",
    "width_sharding",
    "sr_radius",
    "bsvd_radius",
    "egvsr_radius",
    "upscale_radius",
    "denoise_radius",
    "sr_align",
]

# LR columns an SR epilogue reads past its conv stack: the nearest or
# bicubic resampling of the residual and output, and the fused
# epilogue's edge-replicated block
_EPILOGUE = 2
# the local colour match's reach in SR-output columns: its 17-tap blur
# (8 each side) at 1/8 scale, the area step and the bilinear step
_LOCAL_MATCH = (8 + 1 + 1) * 8


def sr_radius(cfg) -> int:
    """LR columns on each side that an SR model's output column reads:
    an SRVGGConfig, an RRDBConfig, or "fsrcnn"."""
    if isinstance(cfg, srvgg.SRVGGConfig):
        return cfg.num_conv + 2 + _EPILOGUE  # head, body, tail
    if isinstance(cfg, rrdbnet.RRDBConfig):
        body = 1 + 15 * cfg.num_block + 1  # conv_first, 3 RDBs of 5 convs a block, conv_body
        if cfg.scale == 2:
            return 2 * body + 3 + _EPILOGUE  # at half the LR width, then up convs at 1x and 2x
        return body + 2 + _EPILOGUE  # up convs at 2x and 4x, conv_hr, conv_last
    if cfg == "fsrcnn":
        return 2 + 4 + 2 + _EPILOGUE  # 5x5 feature conv, four 3x3 maps, the 9x9 stride-4 deconv
    raise ValueError(f"no radius for SR model config {cfg!r}")


def sr_align(cfg) -> int:
    """LR columns a band's edges must be a multiple of for the SR model:
    RRDBNet x2 works on the 2x2 pixel-unshuffled frame."""
    return 2 if isinstance(cfg, rrdbnet.RRDBConfig) and cfg.scale == 2 else 1


def bsvd_radius(cfg: bsvd.BSVDConfig = bsvd.BSVD_32) -> int:
    """LR columns on each side that BSVD's output and new state read of
    its input frames and state: per DenBlock, on its longest path, four
    full-width 3x3 convs (1 column each), six at half width (2 each, the
    stride-2 conv into it included) and six at quarter width (4 each);
    two DenBlocks.  Independent of the channel widths."""
    return 2 * (4 * 1 + 6 * 2 + 6 * 4)


def egvsr_radius(cfg: egvsr.EGVSRConfig = egvsr.DEFAULT) -> int:
    """LR columns on each side that an EGVSR step's output and new state
    read of the frame and the LR state (the HR state is gathered whole):
    FNet's 14 convs across its four scales and its up- and downsamplings
    (65), the flow's upsampling (1), SRNet's 2 nb + 2 convs, and the
    output resize (1)."""
    return 65 + 1 + 2 * cfg.nb + 2 + 1


def upscale_radius(sr_cfg, sr_ratio) -> int:
    """The SR-only step (upscale_multi): the SR model, the local colour
    match at the SR output's scale (sr_ratio: its width over the LR
    width), and the output resize."""
    return sr_radius(sr_cfg) + ceil(_LOCAL_MATCH / Fraction(sr_ratio)) + 1


def denoise_radius(sr_cfg, bsvd_cfg: bsvd.BSVDConfig = bsvd.BSVD_32) -> int:
    """The denoise step: BSVD, the LR sharpen, the SR model, the HR
    sharpen and the output resize."""
    return bsvd_radius(bsvd_cfg) + 1 + sr_radius(sr_cfg) + 1 + 1


def width_sharding(mesh: Mesh):
    """Per-leaf W sharding for image-like pytrees: the width axis (always
    ndim-2 in the NHWC and (T, N, H, W, C) layouts) is split over every
    mesh axis; leaves with fewer than 3 dims (the BSVD frame counter)
    stay whole on every device.  The sharded state's layout
    (ShardedState)."""

    def leaf(x):
        nd = getattr(x, "ndim", 0)
        if nd < 3:
            return NamedSharding(mesh, P())
        spec = [None] * nd
        spec[nd - 2] = AXES
        return NamedSharding(mesh, P(*spec))

    return leaf


# ------------------------------------------------------------ geometry


def _out_constraints(spec: UpscaleSpec, frame_w: int) -> list:
    """What the emitted columns ask of a band's edges: whole output
    columns (even ones for yuv420p's 2x2 chroma) and whole periods of the
    fused ps4 + bicubic epilogue where the output ratio allows one."""
    m = 2 if spec.pix_fmt == "yuv420p" else 1
    out = [(spec.scale, m)]
    if spec.output_shape is not None:
        ro = Fraction(spec.output_shape[1], frame_w)
        f = Fraction(4 * frame_w, spec.output_shape[1])
        out += [(ro, m), (ro, 4 * f.denominator // gcd(f.numerator, 4 * f.denominator))]
    return out


def _band_spec(spec: UpscaleSpec, band: Band, frame_w: int) -> UpscaleSpec:
    """The spec of one band's step: its LR width and output width, at the
    whole frame's ratios."""
    w = band.hi - band.lo
    out = spec.output_shape
    if out is not None:
        out = (out[0], int(Fraction(out[1] * w, frame_w)))
    return spec._replace(lr_shape=(spec.lr_shape[0], w), output_shape=out)


def _in_cols(band: Band, frame_w: int, in_w: int) -> slice:
    """A band's columns [lo, hi) in the input frames, in_w wide."""
    return slice(cols(band.lo, frame_w, frame_w, in_w), cols(band.hi, frame_w, frame_w, in_w))


def _whole_width(part: torch.Tensor, band: Band, frame_w: int, axis: int = 2) -> int:
    v = Fraction(part.shape[axis] * frame_w, band.hi - band.lo)
    if v.denominator != 1:
        raise ValueError(f"a band {band.hi - band.lo} LR columns wide emitted {part.shape[axis]} columns")
    return int(v)


def _gather_out(outs: list[torch.Tensor], bands: list[Band], frame_w: int, spec: UpscaleSpec,
                dev: torch.device) -> torch.Tensor:
    """The emitted frames (rgb24 NHWC or planar yuv420p, W on axis 2) of
    every band, cropped to the centres and put side by side on dev."""
    full_w = _whole_width(outs[0], bands[0], frame_w)
    if spec.pix_fmt == "yuv420p":
        return gather_yuv420(outs, bands, frame_w, full_w, dev)
    return gather_bands(outs, bands, frame_w, full_w, 2, dev)


def _centre(x: torch.Tensor, band: Band, frame_w: int) -> torch.Tensor:
    """A band's centre columns of a (..., H, w, C) tensor of its own."""
    sl = band_slice(band, frame_w, frame_w, _whole_width(x, band, frame_w, x.ndim - 2), centre=True)
    return x.narrow(x.ndim - 2, sl.start, sl.stop - sl.start)


def _colour_stats(hrs: list, lrs: list, bands: list[Band], frame_w: int, dev: torch.device) -> list[tuple]:
    """Each band's (mu_hr, std_hr, mu_ref, std_ref) for
    ops.global_color_match, over the whole frame's centres."""
    hs = shared_stats([_centre(h, b, frame_w) for h, b in zip(hrs, bands)], dev)
    ls = shared_stats([_centre(lr, b, frame_w) for lr, b in zip(lrs, bands)], dev)
    return [(*h, *lr) for h, lr in zip(hs, ls)]


class _Replicas:
    """Parameters on each device, copied once per parameter tree (kept by
    identity, with a reference so that the identity stays valid)."""

    def __init__(self, devices) -> None:
        self.devices = devices
        self._key, self._reps = None, None

    def __call__(self, params) -> dict:
        if self._key is not params:
            self._key, self._reps = params, replicate(params, self.devices)
        return self._reps


def _state_in(state, bands: list[Band], frame_w: int, base_w: int) -> ShardedState:
    """The state as bands: a ShardedState of these bands has its halos
    written again; any other state (a whole one, or bands of another
    split) is split anew, so that it stays as it was."""
    if isinstance(state, ShardedState) and state.bands == bands and state.frame_w == frame_w:
        state.refresh()
        return state
    if isinstance(state, ShardedState):
        state = state.gather()
    return shard_state(state, bands, frame_w, base_w)


# ------------------------------------------------------------ factories


def make_sharded_upscale(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    spec: UpscaleSpec,
    mesh: Mesh,
    *,
    halo: int | None = None,
    align: int = 1,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """`fn(params, frames_u8) -> out_u8`, upscale_multi with the batch
    over "data" and W over "spatial" (bands with `halo` LR columns each
    side, upscale_radius; `align`: the SR model's, sr_align).  The batch
    must divide by mesh.shape['data'] (see mesh.pad_batch).  The output
    is whole on the mesh's first device."""
    rows = [list(r) for r in mesh.devices]
    replicas = _Replicas(mesh.device_list)
    dev0 = mesh.device_list[0]

    def fn(params, frames):
        n, h, in_w, _ = frames.shape
        if n % len(rows):
            raise ValueError(f"batch {n} does not divide by the mesh's data axis ({len(rows)}); "
                             "pad it (parallel.pad_batch)")
        lr_h, lr_w = spec.lr_shape
        resized = spec.lr_hr_resize and (h > lr_h or in_w > lr_w)
        frame_w = lr_w if resized else in_w
        # the local colour match works at 1/8 of the SR output's width
        a = alignment(align, [(Fraction(in_w, frame_w), 1), (1, 8), *_out_constraints(spec, frame_w)]
                      + ([(Fraction(spec.output_shape[1], frame_w), 8)] if spec.output_shape else []))
        reps = replicas(params)
        nb = n // len(rows)
        outs = []
        for r, row in enumerate(rows):
            bands = split_width(frame_w, row, a, halo)
            hrs, lrs, specs = [], [], []
            for band in bands:
                bspec = _band_spec(spec, band, frame_w)
                with on_device(band.device):
                    x = put(frames[r * nb : (r + 1) * nb, :, _in_cols(band, frame_w, in_w)], band.device)
                    hr, lr = _multi_local(sr_apply, reps[band.device], x, bspec)
                hrs.append(hr)
                lrs.append(lr)
                specs.append(bspec)
            full_hw = (hrs[0].shape[-3], _whole_width(hrs[0], bands[0], frame_w))
            if len(bands) > 1 and full_hw[1] % 8 and full_hw[0] > 64 and full_hw[1] > 64:
                raise ValueError(f"an SR output {full_hw[1]} wide does not split for the local colour "
                                 "match (a multiple of 8 is needed)")
            stats = _colour_stats(hrs, lrs, bands, frame_w, dev0)
            parts = []
            for band, hr, lr, bspec, st in zip(bands, hrs, lrs, specs, stats):
                with on_device(band.device):
                    parts.append(_multi_finish(hr, lr, bspec, st, full_hw=full_hw))
            outs.append(_gather_out(parts, bands, frame_w, spec, dev0))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return fn


def _denoise_plan(spec: UpscaleSpec, devices, in_w: int, halo, align: int):
    frame_w = spec.lr_shape[1]
    a = alignment(max(4, align), [(Fraction(in_w, frame_w), 1), *_out_constraints(spec, frame_w)])
    return frame_w, split_width(frame_w, devices, a, halo)


def _denoise_tail(sr_apply, reps, fronts, bands, frame_w, spec, sr_sub_batch, dev0):
    """The SR stage and colour match of a sharded denoise chunk, sub-batch
    by sub-batch as upscale_batch_denoise runs them: every band's local
    part, the shared statistics, every band's finish."""
    specs = [_band_spec(spec, b, frame_w) for b in bands]
    outs = []
    for sl in _sub_batches(fronts[0][1].shape[0], sr_sub_batch):
        hrs = []
        for band, (den, lr), bspec in zip(bands, fronts, specs):
            with on_device(band.device):
                hrs.append(_denoise_local(sr_apply, reps[band.device], den[sl], lr[sl], bspec))
        stats = _colour_stats(hrs, [lr[sl] for _, lr in fronts], bands, frame_w, dev0)
        parts = []
        for band, hr, (_, lr), bspec, st in zip(bands, hrs, fronts, specs, stats):
            with on_device(band.device):
                parts.append(_denoise_finish(hr, lr[sl], bspec, st))
        outs.append(_gather_out(parts, bands, frame_w, spec, dev0))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def make_sharded_denoise(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    spec: UpscaleSpec,
    mesh: Mesh,
    cfg: bsvd.BSVDConfig | None = None,
    warm: bool = False,
    sr_sub_batch: int | None = None,
    *,
    halo: int | None = None,
    align: int = 1,
) -> Callable:
    """Sharded denoise micro-batch step: `fn(params, state, frames_u8) ->
    (out_u8, new_state)`, upscale_batch_denoise with W split over every
    device of the mesh (the chunk axis T is temporal, so it cannot ride
    a data axis), `halo` LR columns each side (denoise_radius).

    Each band runs bsvd.chunk_step through K1 and the SR body through K4
    at its own width.  The state enters whole or as a ShardedState and
    leaves as a ShardedState (gather_state makes it whole); a warm step
    writes the new frames into the band states' skip rings in place, as
    the service's step does, so a ShardedState passed to it is consumed
    (a whole state is split into copies first)."""
    cfg = cfg or bsvd.BSVD_32
    devices = mesh.device_list
    replicas = _Replicas(devices)

    def fn(params, state, frames):
        frame_w, bands = _denoise_plan(spec, devices, frames.shape[2], halo, align)
        sh = _state_in(state, bands, frame_w, -(-frame_w // 4) * 4)
        reps = replicas(params)
        fronts, new_parts = [], []
        for band, part in zip(bands, sh.parts):
            with on_device(band.device):
                x = put(frames[:, :, _in_cols(band, frame_w, frames.shape[2])], band.device)
                den, lr, new = _denoise_front(reps[band.device], part, x, _band_spec(spec, band, frame_w), cfg,
                                              warm=warm, inplace=True)
            fronts.append((den, lr))
            new_parts.append(new)
        out = _denoise_tail(sr_apply, reps, fronts, bands, frame_w, spec, sr_sub_batch, devices[0])
        return out, sh.replace(new_parts)

    return fn


def make_sharded_denoise_flush(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    spec: UpscaleSpec,
    mesh: Mesh,
    cfg: bsvd.BSVDConfig | None = None,
    *,
    halo: int | None = None,
    align: int = 1,
) -> Callable:
    """Sharded EOF flush of the BSVD lookahead: `fn(params, state,
    lr_tail_u8, t_end) -> (out_u8, new_state)`, flush_batch_denoise on the
    bands of make_sharded_denoise, so a mesh-backed service drains its
    sharded state without gathering it."""
    cfg = cfg or bsvd.BSVD_32
    devices = mesh.device_list
    replicas = _Replicas(devices)

    def fn(params, state, lr_tail, t_end):
        frame_w, bands = _denoise_plan(spec, devices, lr_tail.shape[2], halo, align)
        sh = _state_in(state, bands, frame_w, -(-frame_w // 4) * 4)
        reps = replicas(params)
        fronts, new_parts = [], []
        for band, part in zip(bands, sh.parts):
            with on_device(band.device):
                x = put(lr_tail[:, :, _in_cols(band, frame_w, lr_tail.shape[2])], band.device)
                den, lr, new = _flush_front(reps[band.device], part, x, t_end, _band_spec(spec, band, frame_w), cfg)
            fronts.append((den, lr))
            new_parts.append(new)
        out = _denoise_tail(sr_apply, reps, fronts, bands, frame_w, spec, None, devices[0])
        return out, sh.replace(new_parts)

    return fn


def make_sharded_egvsr_step(
    spec: UpscaleSpec,
    mesh: Mesh,
    cfg: egvsr.EGVSRConfig | None = None,
    cut_threshold: float | None = None,
    *,
    halo: int | None = None,
) -> Callable:
    """Sharded frame-recurrent EGVSR step: `fn(params, state, frame_u8) ->
    (out_u8, new_state)`, W split over every device of the mesh (a
    recurrent stream has no batch to split), `halo` LR columns each side
    (None: egvsr_radius of cfg).  The state (lr_prev, hr_prev) enters
    whole or as a ShardedState and leaves as a ShardedState.  The HR warp
    is the plain gather (_sharded_egvsr_body): no K3 launch."""
    cfg = cfg or egvsr.DEFAULT
    devices = mesh.device_list
    replicas = _Replicas(devices)
    radius = egvsr_radius(cfg) if halo is None else halo

    def fn(params, state, frame):
        n, h, in_w, _ = frame.shape
        lr_h, lr_w = spec.lr_shape
        resized = spec.lr_hr_resize and (h > lr_h or in_w > lr_w)
        frame_w = lr_w if resized else in_w
        a = alignment(8, [(Fraction(in_w, frame_w), 1), *_out_constraints(spec, frame_w)])
        bands = split_width(frame_w, devices, a, radius)
        sh = _state_in(state, bands, frame_w, frame_w)
        return _sharded_egvsr_body(replicas(params), sh, frame, spec, cfg, cut_threshold, frame_w, in_w)

    return fn


def _sharded_egvsr_body(reps: dict, sh: ShardedState, frame, spec: UpscaleSpec, cfg, cut_threshold,
                        frame_w: int, in_w: int):
    """egvsr_upscale_step on the bands: each band's LR frame and flow at
    its own width, the previous HR frame gathered whole to every device,
    each band's columns warped from it in the frame's coordinates (border
    clamp at the frame's edges) by the plain gather warp, the scene-cut
    test over the whole frame, then SRNet and the emission per band."""
    bands = sh.bands
    dev0 = bands[0].device
    s = cfg.scale
    lrs = []
    for band in bands:
        with on_device(band.device):
            x = put(frame[:, :, _in_cols(band, frame_w, in_w)], band.device)
            lrs.append(_egvsr_lr(x, _band_spec(spec, band, frame_w)))
    hr_prev = gather_bands([p[1] for p in sh.parts], bands, frame_w, s * frame_w, 2, dev0)
    hr_whole = {}
    for band in bands:
        if band.device not in hr_whole:
            hr_whole[band.device] = put(hr_prev, band.device)
    skips = [None] * len(bands)
    if cut_threshold is not None:
        # egvsr._cut_flags over the whole frame: the mean of |lr - lr_prev|
        # from the centres' sums
        total = sum(put(_centre((lr.float() - p[0].float()).abs(), b, frame_w).sum(), dev0)
                    for lr, p, b in zip(lrs, sh.parts, bands))
        count = lrs[0].shape[0] * lrs[0].shape[1] * frame_w * lrs[0].shape[3]
        cut = (total / count > cut_threshold).reshape(())
        skips = [put(cut, b.device) for b in bands]
    outs, new_parts = [], []
    for band, lr, part, skip in zip(bands, lrs, sh.parts, skips):
        p = reps[band.device]
        with on_device(band.device):
            flow = egvsr._hr_flow(p, lr, part[0], cfg)
            whole = hr_whole[band.device]
            warped = backward_warp_columns(whole, flow, s * band.lo)
            if skip is not None:
                own = whole.narrow(2, s * band.lo, flow.shape[2])
                warped = torch.where(skip, own, warped)
            hr = egvsr.srnet_apply(p["srnet"], lr, space_to_depth(warped, s).to(lr.dtype))
            bspec = _band_spec(spec, band, frame_w)
            outs.append(_emit(_resize_to_output(torch.clamp(hr.float(), 0.0, 1.0), bspec), bspec))
        new_parts.append((lr, hr))
    return _gather_out(outs, bands, frame_w, spec, dev0), sh.replace(new_parts)


# ------------------------------------------------------------ training

# FNet pools by 2 three times: band edges on multiples of 8 LR columns
# pool a band at the whole clip's positions
_FNET_ALIGN = 8


def make_sharded_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """Shard a train/vsr.make_train_step function over the mesh:
    `fn(state, lr_data, gt_data) -> (state, logs)` with the batch of
    (N, T, h, w, C) clips over "data" and the width over "spatial", the
    TrainState (parameters and Adam moments) on the mesh's first device,
    where the caller sees it, and `logs` with the single-device step's
    keys (l_pix_G, l_warp_G, l_total).

    The step reads the loss function and the schedule that train_step
    exposes (`train_step.loss_fn`, whose `cfg` is the VSRTrainConfig, and
    `train_step.schedule`); a step without them (the GAN step) raises a
    TypeError.  N must divide by the data axis.

    Each call copies the parameters to every other device of the mesh
    through autograd (`Tensor.to`), so they are fresh at every call and
    each device's part of the gradient flows back into the one set of
    parameters on the first device, where autograd sums them;
    vsr.apply_gradients then makes one optimizer step there.  No
    torch.distributed and no NCCL.

    The width is split into bands (parallel/_bands.py) with a halo of
    egvsr_radius(cfg) LR columns, rounded up to FNet's alignment of 8.
    Frame by frame, each band computes its LR flow and SRNet output on
    its columns; the previous HR frame is gathered whole from the bands'
    centres to every device (as the serving step does), and each band
    warps its columns from it in the frame's coordinates, border clamp
    at the frame's edges.  Each band's loss covers its centre columns
    only: the pixel loss on its HR centre, the warp loss on its LR
    centre (whose warp reads the whole previous LR frame).  A criterion
    that sums (Charbonnier by default) adds up over bands and data
    shards; a mean (MSE by default) is that sum over the whole clip's
    element count (train.losses.criterion_parts; any other criterion
    raises a ValueError).  So the bands' gradients sum to the whole
    step's, up to rounding, as long as the halo covers the step's
    radius.

    What the spatial axis buys: configs/egvsr_bd.yml's FRNet (nf 64,
    nb 10) has a radius of 65 + 1 + 20 + 2 + 1 = 89 LR columns (a halo
    of 96), wider than its crop's 32 LR columns (GT crop 128), so at
    that crop every band computes the whole clip and keeps its centre's
    loss: exact, and no saving.  The spatial axis only pays at crops
    wider than about twice the radius (some 180 LR columns); below that
    the data axis is the one that splits the work."""
    # imported here, so that the serving steps do not load the training tree
    from ..train.losses import criterion_parts
    from ..train.vsr import apply_gradients, param_leaves

    missing = [a for a in ("loss_fn", "schedule") if not hasattr(train_step, a)]
    if missing:
        raise TypeError(f"make_sharded_train_step needs the step's loss function and schedule, as "
                        f"train.vsr.make_train_step exposes them; this train_step has no "
                        f"{' and no '.join(missing)}")
    cfg = getattr(train_step.loss_fn, "cfg", None)
    if cfg is None:
        raise TypeError("make_sharded_train_step needs train_step.loss_fn.cfg (the VSRTrainConfig of "
                        "train.vsr.make_loss_fn)")
    pix = criterion_parts(cfg.pixel_crit or {"type": "CB"})
    warp = criterion_parts(cfg.warping_crit or {"type": "CB"})
    rows = [list(r) for r in mesh.devices]
    devices = mesh.device_list
    dev0 = devices[0]
    halo = egvsr_radius(cfg.model_cfg)

    def fn(state, lr_data, gt_data):
        n, t, h, w, c = lr_data.shape
        if n % len(rows):
            raise ValueError(f"batch {n} does not divide by the mesh's data axis ({len(rows)})")
        for p in param_leaves(state.params):
            if p.device != dev0:
                raise ValueError(f"the train state's parameters must lie on the mesh's first device {dev0}, "
                                 f"not {p.device}")
        reps = replicate(state.params, devices)
        nb = n // len(rows)
        sums = [0.0, 0.0]
        for r, row in enumerate(rows):
            bands = split_width(w, row, _FNET_ALIGN, halo)
            parts = _band_train_losses(reps, bands, lr_data[r * nb : (r + 1) * nb],
                                       gt_data[r * nb : (r + 1) * nb], cfg.model_cfg, pix[0], warp[0], dev0)
            sums = [a + b for a, b in zip(sums, parts)]
        s = cfg.model_cfg.scale
        counts = (n * t * h * s * w * s * c, n * (t - 1) * h * w * c)
        loss_pix, loss_warp = (
            weight * (total / count if mean else total)
            for weight, total, count, mean in zip((cfg.pixel_weight, cfg.warping_weight), sums, counts,
                                                  (pix[1], warp[1])))
        loss = loss_pix + loss_warp
        apply_gradients(state, loss, train_step.schedule)
        logs = {"l_pix_G": loss_pix, "l_warp_G": loss_warp, "l_total": loss}
        return state, {k: v.detach() for k, v in logs.items()}

    return fn


def _band_train_losses(reps: dict, bands: list[Band], lr_data, gt_data, cfg: egvsr.EGVSRConfig, pix_part,
                       warp_part, dev0: torch.device) -> list:
    """egvsr.forward_sequence and the VSR loss on the bands of one data
    shard: the pixel and warp criteria summed over the bands' centres,
    each on dev0.  It mirrors train.vsr.make_loss_fn, band by band."""
    n, t, h, w, c = lr_data.shape
    s = cfg.scale
    xs, hr_flows, sums = [], [], [0.0, 0.0]
    lr_prev_whole = lr_data[:, :-1].reshape(n * (t - 1), h, w, c)
    lr_curr_whole = lr_data[:, 1:].reshape(n * (t - 1), h, w, c)
    for band in bands:
        p, bw = reps[band.device], band.hi - band.lo
        centre = slice(band.c0 - band.lo, band.c1 - band.lo)
        with on_device(band.device):
            x = put(lr_data[:, :, :, band.lo : band.hi], band.device)
            lr_prev = x[:, :-1].reshape(n * (t - 1), h, bw, c)
            lr_curr = x[:, 1:].reshape(n * (t - 1), h, bw, c)
            lr_flow = egvsr._lr_flow(p, lr_curr, lr_prev)
            hr_flows.append(egvsr._upsample_flow(lr_flow, h, bw, cfg).reshape(n, t - 1, h * s, bw * s, 2))
            # the warp loss on the band's LR centre, the previous LR frame
            # read whole
            lr_warp = backward_warp_columns(put(lr_prev_whole, band.device), lr_flow, band.lo)
            y = put(lr_curr_whole[:, :, band.c0 : band.c1], band.device)
            sums[1] = sums[1] + put(warp_part(lr_warp[:, :, centre], y), dev0)
        xs.append(x)
    hrs = []
    for band, x in zip(bands, xs):
        with on_device(band.device):
            zero = x.new_zeros((n, h, band.hi - band.lo, s * s * c))
            hrs.append([egvsr.srnet_apply(reps[band.device]["srnet"], x[:, 0], zero)])
    for i in range(1, t):
        hr_prev = gather_bands([hr[-1] for hr in hrs], bands, w, s * w, 2, dev0)
        whole = {}
        for band, x, hr, flow in zip(bands, xs, hrs, hr_flows):
            if band.device not in whole:
                whole[band.device] = put(hr_prev, band.device)
            with on_device(band.device):
                warped = backward_warp_columns(whole[band.device], flow[:, i - 1], s * band.lo)
                hr.append(egvsr.srnet_apply(reps[band.device]["srnet"], x[:, i], space_to_depth(warped, s)))
    for band, hr in zip(bands, hrs):
        centre = slice(s * (band.c0 - band.lo), s * (band.c1 - band.lo))
        with on_device(band.device):
            gt = put(gt_data[:, :, :, s * band.c0 : s * band.c1], band.device)
            sums[0] = sums[0] + put(pix_part(torch.stack(hr, dim=1)[:, :, :, centre], gt), dev0)
    return sums
