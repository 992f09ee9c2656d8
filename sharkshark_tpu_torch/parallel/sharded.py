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
  in the frame's coordinates through K3 with the band's column origin
  (the JAX factory warps with the gather and lets XLA partition it);
- EGVSR's scene-cut test, a mean over the whole frame.

Tensors go in on any device (host frames are uploaded band by band
through pinned memory) and the outputs come back whole on the mesh's
first device.  `halo=None` gives every band the whole frame: exact for
any sr_apply, at no saving.

As the JAX factories keep one compiled executable per frame shape, each
factory keeps compiled forms: every band's device-local work runs
through ShapeCaches of its own (upscale/jit_cache.py), one CUDA graph per
signature on the card, and only the exchanges above, the halo refresh,
the uploads and the gathers run eagerly between the replays
(_BandCaches).  On the CPU the caches run eagerly.  The sharded train
step is compiled too, as the JAX one is jitted: the whole step in one
CUDA graph on a mesh of one device, per-band segment graphs across cards
(make_sharded_train_step).
"""

from __future__ import annotations

import contextlib
import gc
from fractions import Fraction
from math import ceil, gcd
from typing import Any, Callable

import torch

from ..models import bsvd, egvsr, rrdbnet, srvgg
from ..ops import space_to_depth
from ..ops.warp import backward_warp_columns, backward_warp_fast
from ..upscale.jit_cache import MAX_GRAPHS, GraphPool, ShapeCache, _flatten, _leaf_sig
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
    _warm_index,
)
from ._bands import (
    Band,
    ShardedState,
    _leaves,
    alignment,
    band_slice,
    cols,
    gather_bands,
    gather_yuv420,
    on_device,
    put,
    put_each,
    replicate,
    shard_state,
    shared_stats,
    split_width,
    tree_map,
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


def _band_cols(xs: dict, band: Band, frame_w: int) -> torch.Tensor:
    """A band's columns of the input frames (N, H, in_w, C), from the
    frames whole on its device (put_each), as a tensor of its own."""
    x = xs[band.device]
    return x[:, :, _in_cols(band, frame_w, x.shape[2])].contiguous()


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


# factories made inside _eager_reference() run their bands' phases
# without a graph
_EAGER = [False]


@contextlib.contextmanager
def _eager_reference():
    """Factories made inside this block (directly or by a service's
    proc_init) run every band's phases eagerly, with no ShapeCache: the
    reference that chip_smoke and the card tests hold the graphs against.
    No service option, flag or variable reaches it."""
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = False


class _BandCaches:
    """A factory's compiled forms, the counterpart of the JAX factories'
    `compiled[frames.shape]`: one ShapeCache per (phase, band position),
    made at the band's first call, on one GraphPool and tagged with the
    band's position, so that each band keeps its own static buffers (two
    bands of equal width on one device must not share a state).  A
    cache's signature carries the band's shapes and its spec, so one
    cache holds a graph per frame shape.  `caches` maps (phase,
    position) to the cache."""

    def __init__(self, pool: GraphPool | None = None) -> None:
        self.pool = pool if pool is not None else GraphPool()
        self.eager = _EAGER[0]
        self.caches: dict = {}

    def phase(self, name: str, fn: Callable, **kw) -> Callable:
        """`run(position, *args)`: fn through the band's cache (kw:
        ShapeCache's donate_argnums and fixed_argnums)."""

        def run(pos, *args):
            if self.eager:
                return fn(*args)
            cache = self.caches.get((name, pos))
            if cache is None:
                cache = self.caches[(name, pos)] = ShapeCache(fn, pool=self.pool, tag=pos, **kw)
            return cache(*args)

        return run


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
    is whole on the mesh's first device.

    Each band (data row r, position k) runs _multi_local through its
    cache ("local", (r, k)), then the shared statistics eagerly, then
    _multi_finish through its cache ("finish", (r, k)); `fn.band_caches`
    holds them.  The weights are fixed arguments: pass the same tree."""
    rows = [list(r) for r in mesh.devices]
    replicas = _Replicas(mesh.device_list)
    dev0 = mesh.device_list[0]
    caches = _BandCaches()
    local = caches.phase("local", lambda p, x, bspec: _multi_local(sr_apply, p, x, bspec), fixed_argnums=(0,))
    finish = caches.phase("finish", lambda hr, lr, st, bspec, full_hw: _multi_finish(hr, lr, bspec, st,
                                                                                       full_hw=full_hw))

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
            xs = put_each(frames[r * nb : (r + 1) * nb], [b.device for b in bands])
            hrs, lrs, specs = [], [], []
            for k, band in enumerate(bands):
                bspec = _band_spec(spec, band, frame_w)
                with on_device(band.device):
                    hr, lr = local((r, k), reps[band.device], _band_cols(xs, band, frame_w), bspec)
                hrs.append(hr)
                lrs.append(lr)
                specs.append(bspec)
            full_hw = (hrs[0].shape[-3], _whole_width(hrs[0], bands[0], frame_w))
            if len(bands) > 1 and full_hw[1] % 8 and full_hw[0] > 64 and full_hw[1] > 64:
                raise ValueError(f"an SR output {full_hw[1]} wide does not split for the local colour "
                                 "match (a multiple of 8 is needed)")
            stats = _colour_stats(hrs, lrs, bands, frame_w, dev0)
            parts = []
            for k, (band, hr, lr, bspec, st) in enumerate(zip(bands, hrs, lrs, specs, stats)):
                with on_device(band.device):
                    parts.append(finish((r, k), hr, lr, st, bspec, full_hw))
            outs.append(_gather_out(parts, bands, frame_w, spec, dev0))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    fn.band_caches = caches.caches
    return fn


def _denoise_plan(spec: UpscaleSpec, devices, in_w: int, halo, align: int):
    frame_w = spec.lr_shape[1]
    a = alignment(max(4, align), [(Fraction(in_w, frame_w), 1), *_out_constraints(spec, frame_w)])
    return frame_w, split_width(frame_w, devices, a, halo)


def _untimed(state: dict) -> dict:
    """A BSVD state without its frame index, which a band's cache takes
    as a host int of its own (a graph cannot key on a count that grows
    at every call)."""
    return {k: v for k, v in state.items() if k != "t"}


def _denoise_phases(caches: _BandCaches, sr_apply, sr_sub_batch, front_step: Callable):
    """The two cached phases of a sharded denoise or flush chunk, per
    band: "front" (the BSVD chunk by front_step(p, state, x, t, *rest,
    bspec), with the state donated, then every sub-batch's SR and
    sharpen, _denoise_local) and "finish" (every sub-batch's colour match
    with the shared statistics, clamp, resize and emission)."""

    def front(p, st, x, t, *rest):
        den, lr, new = front_step(p, {"t": t, **st}, x, *rest)
        bspec = rest[-1]
        hrs = tuple(_denoise_local(sr_apply, p, den[sl], lr[sl], bspec)
                    for sl in _sub_batches(lr.shape[0], sr_sub_batch))
        return hrs, lr, _untimed(new)

    def finish(hrs, lr, stats, bspec):
        return tuple(_denoise_finish(hr, lr[sl], bspec, st)
                     for hr, sl, st in zip(hrs, _sub_batches(lr.shape[0], sr_sub_batch), stats))

    return (caches.phase("front", front, donate_argnums=(1,), fixed_argnums=(0,)),
            caches.phase("finish", finish))


def _denoise_bands(front, finish, reps, sh: ShardedState, x_all, key, rest: tuple, frame_w: int, spec,
                   sr_sub_batch, dev0) -> tuple:
    """A sharded denoise or flush chunk through the bands' phases: each
    band's front (its state without `t`, keyed by the host int `key`),
    the statistics of every sub-batch (eager), each band's finish, and
    the gathers.  Returns (out, new ShardedState)."""
    bands = sh.bands
    t = sh.parts[0]["t"]
    xs = put_each(x_all, [b.device for b in bands])
    fronts, new_parts, specs = [], [], []
    for k, (band, part) in enumerate(zip(bands, sh.parts)):
        bspec = _band_spec(spec, band, frame_w)
        with on_device(band.device):
            hrs, lr, new = front(k, reps[band.device], _untimed(part), _band_cols(xs, band, frame_w), key, *rest,
                                 bspec)
        fronts.append((hrs, lr))
        new_parts.append({"t": t + x_all.shape[0], **new})
        specs.append(bspec)
    subs = _sub_batches(x_all.shape[0], sr_sub_batch)
    stats = [_colour_stats([hrs[i] for hrs, _ in fronts], [lr[sl] for _, lr in fronts], bands, frame_w, dev0)
             for i, sl in enumerate(subs)]
    parts = []
    for k, (band, (hrs, lr), bspec) in enumerate(zip(bands, fronts, specs)):
        with on_device(band.device):
            parts.append(finish(k, hrs, lr, tuple(st[k] for st in stats), bspec))
    outs = [_gather_out([p[i] for p in parts], bands, frame_w, spec, dev0) for i in range(len(subs))]
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), sh.replace(new_parts)


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
    pool: GraphPool | None = None,
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
    (a whole state is split into copies first).

    Each band runs its BSVD chunk and SR ("front", the band's state
    donated) and its colour match and emission ("finish") through its own
    ShapeCaches (`fn.band_caches`); the halo refresh, the statistics and
    the gathers run eagerly between them.  The band's state goes in
    without its frame index: a cold chunk is keyed by the index, a warm
    one by its ring phase (steps._warm_index), so a stream holds 8/T warm
    graphs a band.  The donated state comes back as the caches' static
    buffers, which the next call's refresh writes in place.  `pool`: one
    GraphPool for the cold, warm and flush factories of one stream (a
    service's), so that the band's state passes between them without a
    copy."""
    cfg = cfg or bsvd.BSVD_32
    devices = mesh.device_list
    replicas = _Replicas(devices)
    caches = _BandCaches(pool)

    def front_step(p, st, x, bspec):
        return _denoise_front(p, st, x, bspec, cfg, warm=warm, inplace=True)

    front, finish = _denoise_phases(caches, sr_apply, sr_sub_batch, front_step)

    def fn(params, state, frames):
        frame_w, bands = _denoise_plan(spec, devices, frames.shape[2], halo, align)
        sh = _state_in(state, bands, frame_w, -(-frame_w // 4) * 4)
        t = sh.parts[0]["t"]
        key = _warm_index(t, sh.parts[0]["temp1"]["skip1"].shape[0], frames.shape[0]) if warm else t
        return _denoise_bands(front, finish, replicas(params), sh, frames, key, (), frame_w, spec, sr_sub_batch,
                              devices[0])

    fn.band_caches = caches.caches
    return fn


def make_sharded_denoise_flush(
    sr_apply: Callable[[Any, torch.Tensor], torch.Tensor],
    spec: UpscaleSpec,
    mesh: Mesh,
    cfg: bsvd.BSVDConfig | None = None,
    *,
    halo: int | None = None,
    align: int = 1,
    pool: GraphPool | None = None,
) -> Callable:
    """Sharded EOF flush of the BSVD lookahead: `fn(params, state,
    lr_tail_u8, t_end) -> (out_u8, new_state)`, flush_batch_denoise on the
    bands of make_sharded_denoise, so a mesh-backed service drains its
    sharded state without gathering it.  Its bands' phases are cached as
    make_sharded_denoise's, keyed by the frame index and t_end."""
    cfg = cfg or bsvd.BSVD_32
    devices = mesh.device_list
    replicas = _Replicas(devices)
    caches = _BandCaches(pool)

    def front_step(p, st, x, t_end, bspec):
        return _flush_front(p, st, x, t_end, bspec, cfg)

    front, finish = _denoise_phases(caches, sr_apply, None, front_step)

    def fn(params, state, lr_tail, t_end):
        frame_w, bands = _denoise_plan(spec, devices, lr_tail.shape[2], halo, align)
        sh = _state_in(state, bands, frame_w, -(-frame_w // 4) * 4)
        return _denoise_bands(front, finish, replicas(params), sh, lr_tail, sh.parts[0]["t"], (t_end,), frame_w,
                              spec, None, devices[0])

    fn.band_caches = caches.caches
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
    whole or as a ShardedState and leaves as a ShardedState.  Each band
    warps its columns of the whole previous HR frame through K3
    (`backward_warp_fast` with the band's column origin): one launch a
    band and frame on a CUDA tensor, the plain gather on a CPU one.

    Each band runs two cached phases (`fn.band_caches`): "flow" (the LR
    frame, the HR flow and the band's share of the scene-cut sum) and
    "sr" (the warp, the cut's select, SRNet and the emission, the band's
    state donated); the previous HR frame's gather, the cut flag and the
    output's gather run eagerly between them."""
    cfg = cfg or egvsr.DEFAULT
    devices = mesh.device_list
    replicas = _Replicas(devices)
    radius = egvsr_radius(cfg) if halo is None else halo
    caches = _BandCaches()
    s = cfg.scale

    def flow(p, x, lr_prev, bspec, band, frame_w):
        lr = _egvsr_lr(x, bspec)
        f = egvsr._hr_flow(p, lr, lr_prev, cfg)
        if cut_threshold is None:
            return lr, f, None
        # egvsr._cut_flags over the whole frame: the band's centre's sum
        # of |lr - lr_prev|
        return lr, f, _centre((lr.float() - lr_prev.float()).abs(), band, frame_w).sum()

    def sr(p, part, lr, f, whole, skip, lo, bspec):
        hr_tran = backward_warp_fast(whole, f, s2d_out=s, skip=skip, col0=s * lo).to(lr.dtype)
        hr = egvsr.srnet_apply(p["srnet"], lr, hr_tran)
        return _emit(_resize_to_output(torch.clamp(hr.float(), 0.0, 1.0), bspec), bspec), (lr, hr)

    phases = (caches.phase("flow", flow, fixed_argnums=(0,)),
              # the whole previous HR frame is read where it lies: one
              # buffer a device, which each call's gather writes
              caches.phase("sr", sr, donate_argnums=(1,), fixed_argnums=(0, 4)))
    wholes: dict = {}

    def fn(params, state, frame):
        n, h, in_w, _ = frame.shape
        lr_h, lr_w = spec.lr_shape
        resized = spec.lr_hr_resize and (h > lr_h or in_w > lr_w)
        frame_w = lr_w if resized else in_w
        a = alignment(8, [(Fraction(in_w, frame_w), 1), *_out_constraints(spec, frame_w)])
        bands = split_width(frame_w, devices, a, radius)
        sh = _state_in(state, bands, frame_w, frame_w)
        return _sharded_egvsr_body(replicas(params), sh, frame, spec, s, cut_threshold, frame_w, phases, wholes)

    fn.band_caches = caches.caches
    return fn


def _whole_hr(parts: list, bands: list[Band], frame_w: int, full_w: int, wholes: dict) -> dict:
    """The previous HR frame whole on each band's device, gathered from
    the bands' centres into one buffer a device (kept in `wholes` by
    device and shape, so that a graph may read it where it lies)."""
    dev0 = bands[0].device
    hr0 = parts[0][1]
    shape = (hr0.shape[0], hr0.shape[1], full_w, hr0.shape[3])
    out = {}
    for band in bands:
        if band.device not in out:
            key = (band.device, shape, hr0.dtype)
            if key not in wholes:
                wholes[key] = torch.empty(shape, dtype=hr0.dtype, device=band.device)
            out[band.device] = wholes[key]
    pieces = []
    for part, band in zip(parts, bands):
        sl = band_slice(band, frame_w, frame_w, full_w, centre=True)
        pieces.append(put(part[1].narrow(2, sl.start, sl.stop - sl.start), dev0))
    torch.cat(pieces, dim=2, out=out[dev0])
    for dev, buf in out.items():
        if dev != dev0:
            buf.copy_(out[dev0], non_blocking=True)
    return out


def _sharded_egvsr_body(reps: dict, sh: ShardedState, frame, spec: UpscaleSpec, s: int, cut_threshold,
                        frame_w: int, phases: tuple, wholes: dict):
    """egvsr_upscale_step on the bands: each band's LR frame and flow at
    its own width, the previous HR frame gathered whole to every device,
    each band's columns warped from it in the frame's coordinates (border
    clamp at the frame's edges) by K3 with the band's column origin, the
    scene-cut test over the whole frame, then SRNet and the emission per
    band."""
    flow, sr = phases
    bands = sh.bands
    dev0 = bands[0].device
    xs = put_each(frame, [b.device for b in bands])
    fronts = []
    for k, (band, part) in enumerate(zip(bands, sh.parts)):
        with on_device(band.device):
            fronts.append(flow(k, reps[band.device], _band_cols(xs, band, frame_w), part[0],
                               _band_spec(spec, band, frame_w), band, frame_w))
    whole = _whole_hr(sh.parts, bands, frame_w, s * frame_w, wholes)
    skips = [None] * len(bands)
    if cut_threshold is not None:
        # egvsr._cut_flags over the whole frame: the mean of |lr - lr_prev|
        # from the centres' sums
        total = sum(put(cut_sum, dev0) for _, _, cut_sum in fronts)
        lr0 = fronts[0][0]
        count = lr0.shape[0] * lr0.shape[1] * frame_w * lr0.shape[3]
        cut = (total / count > cut_threshold).reshape(())
        skips = [put(cut, b.device) for b in bands]
    outs, new_parts = [], []
    for k, (band, part, (lr, f, _), skip) in enumerate(zip(bands, sh.parts, fronts, skips)):
        with on_device(band.device):
            out, new = sr(k, reps[band.device], part, lr, f, whole[band.device], skip, band.lo,
                          _band_spec(spec, band, frame_w))
        outs.append(out)
        new_parts.append(new)
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
    `train_step.schedule`; a train.compiled.TrainStepCache passes them
    through from the step it wraps); a step without them (the GAN step)
    raises a TypeError.  N must divide by the data axis.

    Each call copies the parameters to every other device of the mesh
    through autograd (`Tensor.to`), so they are fresh at every call and
    each device's part of the gradient flows back into the one set of
    parameters on the first device, where autograd sums them; one
    optimizer step follows there.  No torch.distributed and no NCCL.

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

    The step is split as the recipes' steps are (train/compiled.py): a
    host prologue (the checks, the rate sched(state.step) filled into
    the optimizer, the batch put on the first device), a device body
    (the bands' losses, backward and the optimizer update) and the
    update count.  `fn.split` holds the three parts and `fn.eager` the
    step that runs them eagerly.  The result is compiled per input
    signature, as the JAX function returns a jitted step, by a rule on
    the mesh's devices (`mesh.device_list`):
    - one distinct device (a mesh that repeats one card, or the CPU):
      the whole body is one device's work, and fn is a
      train.compiled.TrainStepCache of the eager step: on the card one
      CUDA graph a signature holds the forward over every band and
      frame, the backward and the capturable Adam;
    - several distinct devices: a CUDA graph lies on one device, and
      each device's backward runs on its own autograd thread, so fn is a
      _SegmentGraphs: each band's device-local work is graphed in
      segments (forward and backward graphs, make_graphed_callables),
      while the exchanges between bands (the previous HR frame's gather
      and its copy to each device, the loss parts' copies to the first
      device and their sums, the replicas' copies) and the optimizer
      update run eagerly between them.
    On CPU tensors both run the body eagerly.  A capture or replay that
    fails raises; nothing turns the graphs off.

    What the spatial axis buys: configs/egvsr_bd.yml's FRNet (nf 64,
    nb 10) has a radius of 65 + 1 + 20 + 2 + 1 = 89 LR columns (a halo
    of 96), wider than its crop's 32 LR columns (GT crop 128), so at
    that crop every band computes the whole clip and keeps its centre's
    loss: exact, and no saving.  The spatial axis only pays at crops
    wider than about twice the radius (some 180 LR columns); below that
    the data axis is the one that splits the work."""
    # imported here, so that the serving steps do not load the training tree
    from ..train.compiled import SplitStep, TrainStepCache, eager_step
    from ..train.losses import criterion_parts
    from ..train.vsr import count_update, optimizer_update, param_leaves, set_rate

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
    schedule = train_step.schedule

    def prologue(state, lr_data, gt_data):
        if lr_data.shape[0] % len(rows):
            raise ValueError(f"batch {lr_data.shape[0]} does not divide by the mesh's data axis ({len(rows)})")
        for p in param_leaves(state.params):
            if p.device != dev0:
                raise ValueError(f"the train state's parameters must lie on the mesh's first device {dev0}, "
                                 f"not {p.device}")
        set_rate(state.opt, schedule(state.step))
        return put(lr_data, dev0), put(gt_data, dev0)

    def body(state, lr_data, gt_data, run: Callable = _run_eagerly):
        n, t, h, w, c = lr_data.shape
        reps = replicate(state.params, devices)
        nb = n // len(rows)
        sums = [0.0, 0.0]
        for r, row in enumerate(rows):
            bands = split_width(w, row, _FNET_ALIGN, halo)
            parts = _band_train_losses(reps, bands, lr_data[r * nb : (r + 1) * nb], gt_data[r * nb : (r + 1) * nb],
                                       cfg.model_cfg, pix[0], warp[0], dev0, run, r)
            sums = [a + b for a, b in zip(sums, parts)]
        s = cfg.model_cfg.scale
        counts = (n * t * h * s * w * s * c, n * (t - 1) * h * w * c)
        loss_pix, loss_warp = (
            weight * (total / count if mean else total)
            for weight, total, count, mean in zip((cfg.pixel_weight, cfg.warping_weight), sums, counts,
                                                  (pix[1], warp[1])))
        loss = loss_pix + loss_warp
        optimizer_update(state.opt, loss)
        logs = {"l_pix_G": loss_pix, "l_warp_G": loss_warp, "l_total": loss}
        return {k: v.detach() for k, v in logs.items()}

    step = eager_step(SplitStep(prologue, body, count_update))
    step.loss_fn, step.schedule = train_step.loss_fn, schedule
    if len(set(devices)) == 1:
        return TrainStepCache(step)
    return _SegmentGraphs(step)


def _run_eagerly(key, fn: Callable, *args):
    """A band's segment run as it is (the eager body's `run`)."""
    return fn(*args)


def _band_train_losses(reps: dict, bands: list[Band], lr_data, gt_data, cfg: egvsr.EGVSRConfig, pix_part,
                       warp_part, dev0: torch.device, run: Callable, row: int) -> list:
    """egvsr.forward_sequence and the VSR loss on the bands of one data
    shard (data row `row`): the pixel and warp criteria summed over the
    bands' centres, each on dev0.  It mirrors train.vsr.make_loss_fn, band
    by band.

    Each band's device-local work is a chain of segments, each called as
    run((row, k, name), fn, *tensor args) for band position k: "front"
    (the LR flow, the HR flow a frame, the warp loss part on the LR
    centre), ("frame", i) for each frame i (the HR warp of the gathered
    previous frame and SRNet; frame 0 with a zero warp) and "pix" (the
    pixel loss part on the HR centre).  The copies between devices and
    the HR gather run between them."""
    n, t, h, w, c = lr_data.shape
    s = cfg.scale
    xs, hr_flows, sums = [], [], [0.0, 0.0]
    lr_prev_whole = lr_data[:, :-1].reshape(n * (t - 1), h, w, c)
    lr_curr_whole = lr_data[:, 1:].reshape(n * (t - 1), h, w, c)
    for k, band in enumerate(bands):
        with on_device(band.device):
            x = put(lr_data[:, :, :, band.lo : band.hi], band.device)
            y = put(lr_curr_whole[:, :, band.c0 : band.c1], band.device)
            flows, part = run((row, k, "front"), _front_segment(band, cfg, warp_part),
                              {"fnet": reps[band.device]["fnet"]}, x, put(lr_prev_whole, band.device), y)
            hr_flows.append(flows)
            sums[1] = sums[1] + put(part, dev0)
        xs.append(x)
    hrs = []
    for k, (band, x) in enumerate(zip(bands, xs)):
        with on_device(band.device):
            hrs.append([run((row, k, ("frame", 0)), _first_frame_segment(s), reps[band.device]["srnet"], x[:, 0])])
    for i in range(1, t):
        hr_prev = gather_bands([hr[-1] for hr in hrs], bands, w, s * w, 2, dev0)
        whole = {}
        for k, (band, x, hr, flows) in enumerate(zip(bands, xs, hrs, hr_flows)):
            if band.device not in whole:
                whole[band.device] = put(hr_prev, band.device)
            with on_device(band.device):
                hr.append(run((row, k, ("frame", i)), _frame_segment(s * band.lo, s), reps[band.device]["srnet"],
                              x[:, i], whole[band.device], flows[i - 1]))
    for k, (band, hr) in enumerate(zip(bands, hrs)):
        with on_device(band.device):
            gt = put(gt_data[:, :, :, s * band.c0 : s * band.c1], band.device)
            sums[0] = sums[0] + put(run((row, k, "pix"), _pix_segment(band, s, pix_part), gt, *hr), dev0)
    return sums


def _front_segment(band: Band, cfg: egvsr.EGVSRConfig, warp_part) -> Callable:
    """front(p, x, lr_prev_whole, y) -> (HR flows, one a frame pair; the
    warp loss part on the band's LR centre): FNet on the band's columns
    x (n, t, h, bw, c), the warp of the whole previous LR frames
    lr_prev_whole against the band's LR flow, y the LR centre's targets."""
    centre = slice(band.c0 - band.lo, band.c1 - band.lo)

    def front(p, x, lr_prev_whole, y):
        n, t, h, bw, c = x.shape
        s = cfg.scale
        lr_prev = x[:, :-1].reshape(n * (t - 1), h, bw, c)
        lr_curr = x[:, 1:].reshape(n * (t - 1), h, bw, c)
        lr_flow = egvsr._lr_flow(p, lr_curr, lr_prev)
        hr_flow = egvsr._upsample_flow(lr_flow, h, bw, cfg).reshape(n, t - 1, h * s, bw * s, 2)
        # the warp loss on the band's LR centre, the previous LR frame read
        # whole
        lr_warp = backward_warp_columns(lr_prev_whole, lr_flow, band.lo)
        return hr_flow.unbind(1), warp_part(lr_warp[:, :, centre], y)

    return front


def _first_frame_segment(s: int) -> Callable:
    """SRNet on the band's first frame, with a zero warped frame."""

    def first_frame(p, x):
        n, h, bw, c = x.shape
        return egvsr.srnet_apply(p, x, x.new_zeros((n, h, bw, s * s * c)))

    return first_frame


def _frame_segment(col0: int, s: int) -> Callable:
    """SRNet on one frame of the band, after the warp of the whole
    previous HR frame along the band's HR flow (HR column col0 on)."""

    def frame(p, x, whole, flow):
        return egvsr.srnet_apply(p, x, space_to_depth(backward_warp_columns(whole, flow, col0), s))

    return frame


def _pix_segment(band: Band, s: int, pix_part) -> Callable:
    """The pixel loss part of the band's HR centre over its frames."""
    centre = slice(s * (band.c0 - band.lo), s * (band.c1 - band.lo))

    def pix(gt, *hrs):
        return pix_part(torch.stack(hrs, dim=1)[:, :, :, centre], gt)

    return pix


class _Zeros:
    """A recorded segment argument: zeros of its shape, dtype and device,
    requiring grad where it did."""

    def __init__(self, shape, dtype, device, requires_grad: bool):
        self.shape, self.dtype, self.device, self.requires_grad = shape, dtype, device, requires_grad

    def make(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device).requires_grad_(self.requires_grad)


def _on_card(tensors: list) -> bool:
    return any(isinstance(x, torch.Tensor) and x.device.type == "cuda" for x in tensors)


class _SegmentGraphs:
    """make_sharded_train_step's compiled step on a mesh of several
    distinct devices: `fn(state, lr_data, gt_data) -> (state, logs)` as
    the eager step it wraps (`fn.eager`, with its parts as `fn.split`).

    Every call runs the prologue, the body and the epilogue.  The body's
    signature is TrainStepCache's: the body's inputs' shapes, dtypes and
    devices, and where each tensor of the state lies.  On CPU tensors the
    body runs eagerly.  On the card:
    - the first call of a signature runs the body eagerly and records
      every segment's arguments (their shapes, dtypes and devices; a
      parameter of the state is kept as itself, so that its graph reads
      it where it lies);
    - the second graphs the segments of each (data row, band) with
      torch.cuda.make_graphed_callables, in the order the body runs
      them, on zeros of those arguments, then runs the body through
      them;
    - every later call runs the body through them: a segment's forward
      copies its arguments into its static inputs and replays its
      forward graph, and autograd's backward replays its backward graph.
    The band's position and data row key its segments, as _BandCaches'
    tags do: two bands of equal width on one device keep their own
    graphs.  make_graphed_callables lets graphs share a pool only where
    their backward graphs replay in the reverse of their forward order: a
    later graph may reuse what an earlier one freed.  Within one (row,
    band) the frames and "pix" replay so (frame i's backward waits for
    frame i + 1's, whose input is frame i's gathered output), and share
    a pool; "front" has a pool of its own, because its backward and
    frame 0's both wait for frame 1's only, and across cards their order
    follows which card's gradient arrives first (frame 0's comes through
    the gather from every card).  Other bands' and rows' segments have
    pools of their own.  The first MAX_GRAPHS signatures that recur are
    captured; any other runs eagerly.  The optimizer update runs eagerly
    on the first device (capturable Adam, a few foreach kernels)."""

    def __init__(self, step: Callable):
        self.eager = step
        self.split = step.split
        self.loss_fn, self.schedule = step.loss_fn, step.schedule
        self._seen: set = set()
        self._samples: dict = {}
        self._graphs: dict = {}
        self._streams: dict = {}

    def __del__(self):
        # make_graphed_callables' callables live in reference cycles (a
        # class each): free their graphs now, when the step is dropped,
        # not when the cycle collector next runs, which may be in the
        # middle of another capture, which a graph freed under it ends
        if self._graphs:
            self._graphs.clear()
            gc.collect()

    def __call__(self, state, *batch):
        from ..train.compiled import _state_sig, state_tensors

        inputs = self.split.prologue(state, *batch)
        leaves: list = []
        struct = _flatten(inputs, leaves)
        fixed = state_tensors(state)
        sig = (struct, tuple(_leaf_sig(x) for x in leaves))
        run = _run_eagerly
        if _on_card(leaves + fixed):
            sig += (_state_sig(state, fixed),)
            if sig in self._graphs:
                run = self._replay(self._graphs[sig])
            elif len(self._graphs) < MAX_GRAPHS:
                if sig in self._samples:
                    self._graphs[sig] = self._capture(self._samples.pop(sig))
                    run = self._replay(self._graphs[sig])
                else:
                    run = self._record(self._samples.setdefault(sig, {}), state)
        self._seen.add(sig)
        logs = self.split.body(state, *inputs, run=run)
        self.split.epilogue(state)
        return state, logs

    @property
    def num_signatures(self) -> int:
        return len(self._seen)

    @property
    def num_graphs(self) -> int:
        """CUDA graphs held: a forward and a backward graph a segment."""
        return sum(2 * len(g) for g in self._graphs.values())

    @staticmethod
    def _record(samples: dict, state) -> Callable:
        """`run` for a signature's first call: each segment runs eagerly,
        and what its graphs' static inputs will be is kept: a parameter of
        the state itself, any other argument as its shape, dtype, device
        and requires_grad (the capture's sample is zeros of those: its
        values are written at every replay)."""
        from ..train.vsr import param_leaves

        own = {id(p) for p in param_leaves(state.params)}

        def sample(x):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"a segment's arguments are tensors, not {type(x).__name__}")
            if id(x) in own:
                return x.detach().requires_grad_(True)
            return _Zeros(x.shape, x.dtype, x.device, x.requires_grad)

        def record(key, fn, *args):
            samples[key] = (fn, tree_map(sample, args))
            return fn(*args)

        return record

    def _capture(self, samples: dict) -> dict:
        groups: dict = {}
        for key, (fn, args) in samples.items():
            args = tree_map(lambda x: x.make() if isinstance(x, _Zeros) else x, args)
            groups.setdefault(key[:2] + (key[2] == "front",), []).append((key, fn, args))
        graphed = {}
        for members in groups.values():
            dev = next(x.device for x in _leaves(members[0][2]))
            with on_device(dev), self._capture_stream(dev):
                fns = torch.cuda.make_graphed_callables(tuple(fn for _, fn, _ in members),
                                                        tuple(args for _, _, args in members))
            graphed.update((key, g) for (key, _, _), g in zip(members, fns))
        return graphed

    @contextlib.contextmanager
    def _capture_stream(self, dev: torch.device):
        """make_graphed_callables captures on torch.cuda.graph's default
        capture stream, which is made once, on the device current at its
        first use: a capture on another card would run on a stream of the
        wrong device.  For the block it is a stream of `dev`."""
        if dev.type != "cuda":
            yield
            return
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        prior = torch.cuda.graph.default_capture_stream
        torch.cuda.graph.default_capture_stream = self._streams[dev]
        try:
            yield
        finally:
            torch.cuda.graph.default_capture_stream = prior

    @staticmethod
    def _replay(graphed: dict) -> Callable:
        def run(key, fn, *args):
            return graphed[key](*args)

        return run
