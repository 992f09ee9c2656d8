"""Upscaler stage services: the device-compute stage of the live pipeline
(counterpart of the JAX package's upscale/service.py).

- BaseUpscalerService: per-job timing and entry repack around an
  `upscale_dispatch()` hook, with an in-flight ring that overlaps the
  device-to-host copy of batch k with the compute of batch k+1, and
  request coalescing (`coalesce_max`) for the stateless SR-only path.
- EsrganUpscalerService: the production path (reference
  FsrcnnUpscalerService, fsrcnn_upscaler.py:86-326, which runs
  RealESRGAN-SRVGG), with the BSVD denoiser on micro-batches and its
  16-frame lookahead drained at end of stream.
- EgvsrUpscalerService: the frame-recurrent EGVSR path (reference
  egvsr_upscaler.py:145-212), one FRNet step per frame (or one batched
  chunk per micro-batch), its HR warp through the K3 kernel.

On the GPU a dispatch enqueues the step on the current CUDA stream, then
a non_blocking copy of the result into pinned host memory and an event;
the fetch waits on that event only.  Tail micro-batches are padded to
batch_size and sliced after, as in the JAX package; coalesced batches
larger than batch_size run at their own size (eager PyTorch keeps no
per-shape executables, so the JAX package's power-of-two padding has no
purpose here).
"""

from __future__ import annotations

import queue
import time
from collections import deque
from dataclasses import dataclass, field
from fractions import Fraction
from math import gcd
from typing import Any

import numpy as np
import torch

from ..models import bsvd, egvsr, fsrcnn, srvgg, torch_import, zoo
from ..runtime import BaseService, Profiler
from ..utils import get_logger, resolve_device
from .levels import LR_LEVELS
from .steps import (
    UpscaleSpec,
    egvsr_upscale_chunk,
    egvsr_upscale_step,
    flush_batch_denoise,
    init_denoise_state,
    upscale_batch_denoise,
    upscale_multi,
)

__all__ = [
    "UpscalerQueueEntry", "BaseUpscalerService", "EsrganUpscalerService", "EgvsrUpscalerService",
]

log = get_logger("upscale.service")


@dataclass
class UpscalerQueueEntry:
    frames: Any = None
    audio_segment: Any = None
    step: int = 0
    elapsed: float = 0.0
    last_modified: float = 0.0
    profiler: Profiler = field(default_factory=Profiler)
    captured_at: float = 0.0  # wall-clock when source frames were captured


class _HostCopy:
    """A device result on its way to host memory: a pinned buffer filled
    by a non_blocking copy, and the CUDA event that marks its end (None
    when the result already lay on the CPU)."""

    def __init__(self, out: torch.Tensor) -> None:
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host = out
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _to_device(device: torch.device, frames: np.ndarray) -> torch.Tensor:
    """Upload frames without waiting: a copy from pinned host memory is
    queued on the stream like any kernel."""
    host = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class BaseUpscalerService(BaseService):
    """Per-job timing + entry repack around `upscale_dispatch()`
    (reference upscaler_base.py:26-63), plus the device-to-host overlap:
    jobs are dispatched and parked in an in-flight ring, and the host
    fetch of batch k happens only after batch k+1 has been dispatched.
    When the job queue idles the ring drains at once (proc_idle).

    coalesce_max > 1 merges jobs of the same frame shape that are already
    queued into one dispatch of up to coalesce_max frames (an image
    service batching concurrent requests); each job still gets its own
    entry back, in order.  Stateless paths only."""

    lr_shape: tuple[int, int] = (720, 1280)
    output_shape: tuple[int, int] | None = (1440, 2560)
    inflight_depth: int = 2  # batches dispatched ahead of the host fetch
    coalesce_max: int = 1

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        self._inflight: deque = deque()
        # cumulative wall seconds blocked in the host fetch (device wait +
        # transfer wait)
        self.fetch_busy_s: float = 0.0

    def _coalesce(self, job: UpscalerQueueEntry) -> list[UpscalerQueueEntry]:
        """Take further already-queued jobs of the same frame shape, up to
        coalesce_max frames in all, to ride one dispatch.  The first job
        that does not fit (or a control sentinel) is stashed back for the
        worker loop, so the order holds."""
        jobs, total = [job], len(job.frames)
        shape = np.asarray(job.frames).shape[1:]
        while total < self.coalesce_max:
            try:
                nxt = self.job_queue.get_nowait()
            except queue.Empty:
                break
            if (
                not isinstance(nxt, UpscalerQueueEntry)
                or nxt.frames is None
                or np.asarray(nxt.frames).shape[1:] != shape
                or total + len(nxt.frames) > self.coalesce_max
            ):
                self._stash.append(nxt)
                break
            jobs.append(nxt)
            total += len(nxt.frames)
        return jobs

    def proc_job_recieved(self, job: UpscalerQueueEntry):
        self.profiler = job.profiler
        self._last_step = job.step
        jobs = self._coalesce(job) if self.coalesce_max > 1 and job.frames is not None else [job]
        for j in jobs:
            j.profiler.end("recoder.output")
            # 'upscaler.upscale' = host dispatch cost; the device/transfer
            # wait surfaces as 'upscaler.fetch' at fetch time
            j.profiler.start("upscaler.upscale")
        t_disp = time.time()
        frames = job.frames if len(jobs) == 1 else np.concatenate([np.asarray(j.frames) for j in jobs])
        dev, _ = self.upscale_dispatch(frames)
        group, start = [], 0
        for j in jobs:
            j.profiler.end("upscaler.upscale")
            group.append((j, start, len(j.frames)))
            start += len(j.frames)
        self._inflight.append((group, dev, t_disp))
        if len(self._inflight) < max(1, self.inflight_depth):
            return None
        return self._fetch_oldest()

    def _fetch_oldest(self) -> list[UpscalerQueueEntry]:
        """The entries of the oldest dispatch, one per job it carried."""
        group, dev, t = self._inflight.popleft()
        elapsed = time.time() - t
        out = []
        for job, start, n in group:
            job.profiler.start("upscaler.fetch")
            t_fetch = time.perf_counter()
            frames_up = self._fetch(dev, n, start)
            self.fetch_busy_s += time.perf_counter() - t_fetch
            job.profiler.end("upscaler.fetch")
            job.profiler.start("upscaler.output")
            out.append(UpscalerQueueEntry(
                frames=frames_up,
                audio_segment=job.audio_segment,
                step=job.step,
                elapsed=elapsed,
                last_modified=time.time(),
                profiler=job.profiler,
                captured_at=job.captured_at,
            ))
        return out

    def proc_idle(self):
        if self._inflight:
            yield from self._fetch_oldest()

    def proc_eof(self):
        while self._inflight:
            yield from self._fetch_oldest()

    @staticmethod
    def _fetch(dev: _HostCopy, n: int, start: int = 0) -> np.ndarray:
        return dev.numpy()[start : start + n]

    def upscale_dispatch(self, frames):  # pragma: no cover - abstract
        """Enqueue the device step for `frames`; return (host copy, n_real)
        without waiting for the device."""
        raise NotImplementedError

    def upscale(self, frames) -> np.ndarray:
        """Synchronous convenience wrapper: dispatch + fetch in one step."""
        dev, n = self.upscale_dispatch(frames)
        return self._fetch(dev, n)


def _fast_epilogue_ratio(lr_shape, output_shape) -> tuple[int, int] | None:
    """(num, den) when the output is the 4x image downscaled by num/den
    with the same ratio on both axes and whole tap periods, so the 4x
    pixel shuffle and the bicubic downscale fuse at LR resolution
    (720p->1440p is 2/1)."""
    oh, ow = output_shape
    lh, lw = lr_shape
    if 4 * lh * ow == 4 * lw * oh and 4 * lh >= oh:
        f = Fraction(4 * lh, oh)
        num, den = f.numerator, f.denominator
        period = 4 * den // gcd(num, 4 * den)
        if oh % period == 0 and ow % period == 0:
            return num, den
    return None


class EsrganUpscalerService(BaseUpscalerService):
    """Production upscaler (reference FsrcnnUpscalerService,
    fsrcnn_upscaler.py:86-326).  upscaler_model: 'realesrgan' (SRVGG
    general-x4v3 with DNI blending of weights_wdn, and the fused epilogue
    where the output ratio allows it), 'fsrcnn' (RGB riding the batch
    dimension), or a model zoo name (models/zoo.py: RRDBNet or SRVGG,
    DNI blending from the weight directory; seeded weights, with a
    warning, when `weights` is None and the zoo's files are absent).  A
    `weights` file that is named but absent raises.

    device: 'cuda' (default) or 'cpu'; a CUDA device on a host without
    CUDA raises here, at construction.  tsm_pair: BSVD's warm mem blocks
    through K2's wrapper (bsvd.chunk_step), which makes the same two K1
    launches as the default route; off by default.  conv_stack: the SRVGG
    body of the model that runs (srvgg_cfg, or a zoo entry's config)
    through K4, that many layers a call (srvgg.apply; 0 = layer by
    layer); None takes srvgg.DEFAULT_CONV_STACK where K4 can run the
    config and 0 where it cannot, or where the model has no SRVGG body; a
    number K4 cannot take for the config raises here.
    coalesce_max: merge queued same-shape requests into one dispatch
    (forced to 1 when denoising: the BSVD stream is temporal, its chunk
    is not a batch)."""

    def __init__(
        self,
        lr_level: int = 3,
        on_queue=None,
        denoising: bool = True,
        denoise_rate: float = 1.0,
        upscaler_model: str = "realesrgan",
        batch_size: int = 1,
        lr_hr_resize: bool = True,
        output_shape: tuple[int, int] | None = (1440, 2560),
        weights: str | None = None,
        weights_wdn: str | None = None,
        denoise_weights: str | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        srvgg_cfg: srvgg.SRVGGConfig = srvgg.GENERAL_X4V3,
        bsvd_cfg: bsvd.BSVDConfig = bsvd.BSVD_32,
        fast_epilogue: bool = True,
        device: str | torch.device = "cuda",
        pix_fmt: str = "rgb24",
        tsm_pair: bool = False,
        conv_stack: int | None = None,
        coalesce_max: int = 1,
    ) -> None:
        super().__init__(name="EsrganUpscaler")
        if upscaler_model not in ("realesrgan", "fsrcnn") and upscaler_model not in zoo.ZOO:
            raise ValueError(f"upscaler_model {upscaler_model!r} unknown; choose from "
                             f"{sorted({'realesrgan', 'fsrcnn'} | set(zoo.ZOO))}")
        self.device = resolve_device(device)
        self.pix_fmt = pix_fmt
        self.lr_shape = LR_LEVELS[lr_level]
        entry = zoo.ZOO.get(upscaler_model)
        self.scale = entry.scale if entry else 4
        self.output_shape = output_shape
        self.on_queue = on_queue
        self.denoising = denoising
        self.denoise_rate = denoise_rate
        self.upscaler_model = upscaler_model
        self.batch_size = batch_size
        self.lr_hr_resize = lr_hr_resize
        self.weights = weights
        self.weights_wdn = weights_wdn
        self.denoise_weights = denoise_weights
        self.compute_dtype = compute_dtype
        self.srvgg_cfg = srvgg_cfg
        self.bsvd_cfg = bsvd_cfg
        self.fast_epilogue = fast_epilogue
        self.tsm_pair = tsm_pair
        body_cfg = srvgg_cfg if upscaler_model == "realesrgan" else entry.cfg if entry else None
        if isinstance(body_cfg, srvgg.SRVGGConfig):
            self.conv_stack = srvgg.resolve_conv_stack(body_cfg, conv_stack)
        elif conv_stack:
            raise ValueError(f"conv_stack={conv_stack}: {upscaler_model} has no SRVGG body for K4")
        else:
            self.conv_stack = 0
        self.coalesce_max = 1 if denoising else max(1, coalesce_max)

    def _load_srvgg_params(self) -> dict:
        """realesr-general-x4v3 weights with DNI denoise-strength blending
        (reference realesrgan/factory.py:140-157); random init if absent."""
        if self.weights is None:
            log.warning("no SRVGG weights given; using random init")
            return srvgg.init_params(torch.Generator().manual_seed(0), self.srvgg_cfg, self.device)
        sd = torch_import.load_state_dict(self.weights)
        if self.weights_wdn is not None and self.denoise_rate < 1.0:
            sd_wdn = torch_import.load_state_dict(self.weights_wdn)
            sd = torch_import.dni_blend(sd, sd_wdn, self.denoise_rate)
        return srvgg.from_torch(sd, self.srvgg_cfg, self.device)

    def _build_sr(self):
        """(sr_apply(params, x), float32 params on the device) of the SR
        model that runs, as the JAX package's proc_init builds them."""
        if self.upscaler_model == "fsrcnn":
            if self.weights is not None:
                params = fsrcnn.from_torch(torch_import.load_state_dict(self.weights), self.device)
            else:
                log.warning("no FSRCNN weights given; using random init")
                params = fsrcnn.init_params(torch.Generator().manual_seed(0), device=self.device)
            return fsrcnn.apply_rgb, params

        if self.upscaler_model in zoo.ZOO:
            kw = dict(denoise_strength=self.denoise_rate, device=self.device, conv_stack=self.conv_stack)
            try:
                sr_apply, params, _ = zoo.build_sr_model(self.upscaler_model, model_path=self.weights, **kw)
            except FileNotFoundError as ex:
                if self.weights is not None:
                    raise
                log.warning("%s; using random init", ex)
                sr_apply, params, _ = zoo.build_sr_model(self.upscaler_model, random_init=True, **kw)
            return sr_apply, params

        cfg = self.srvgg_cfg
        params = self._load_srvgg_params()
        ratio = None
        if self.fast_epilogue and cfg.upscale == 4 and self.output_shape:
            ratio = _fast_epilogue_ratio(self.lr_shape, self.output_shape)
        if ratio:
            log.info("fast epilogue active (fused ps4 + bicubic %d/%d)", *ratio)

            def sr_apply(p, x, r=ratio):
                return srvgg.apply_down_rational(p, x, r[0], r[1], cfg=cfg, conv_stack=self.conv_stack)

        else:

            def sr_apply(p, x):
                return srvgg.apply(p, x, cfg=cfg, conv_stack=self.conv_stack)

        return sr_apply, params

    def proc_init(self) -> None:
        # idempotent, so callers can build and warm the service on their
        # own thread before start()
        if getattr(self, "_initialized", False):
            return
        spec = UpscaleSpec(
            lr_shape=self.lr_shape,
            output_shape=self.output_shape,
            lr_hr_resize=self.lr_hr_resize,
            denoise_rate=self.denoise_rate,
            compute_dtype=self.compute_dtype,
            pix_fmt=self.pix_fmt,
        )
        self.spec = spec
        sr_apply, sr_params = self._build_sr()
        self._sr_apply = sr_apply
        # weights live on the device in the compute dtype, cast once
        sr_params = torch_import.to_tensors(sr_params, self.device, self.compute_dtype)
        self._sr_params = sr_params

        if self.denoising:
            if self.denoise_weights is not None:
                den = bsvd.from_torch(
                    torch_import.load_state_dict(self.denoise_weights), self.bsvd_cfg, self.device
                )
            else:
                log.warning("no BSVD weights given; using random init")
                den = bsvd.init_params(torch.Generator().manual_seed(1), self.bsvd_cfg, self.device)
            den = torch_import.to_tensors(den, self.device, self.compute_dtype)
            self._params = {"sr": sr_params, "denoise": den}
            # past micro-batch 4 the SR tail runs in sub-batches of 4
            self._sr_sub = 4 if self.batch_size > 4 else None
            self.reset_stream()
        log.info("model loaded (%s, denoise=%s, tsm_pair=%s, conv_stack=%d, device=%s)",
                 self.upscaler_model, self.denoising, self.tsm_pair, self.conv_stack, self.device)
        self._initialized = True

    def reset_stream(self) -> None:
        """Start a fresh stream: BSVD's state and the frame bookkeeping of
        the denoise path as proc_init leaves them, so that a caller who
        warmed the service up (proc_init, then upscale) before start()
        feeds the stream cold, as a live stream begins."""
        self._den_state = init_denoise_state(1, self.spec, self.bsvd_cfg, device=self.device)
        # last SHIFT_NUM raw frames: the flush references them for the
        # blend / color match of the drained outputs
        self._tail_frames: list = []
        self._tail_real: list = []
        self._frames_seen = 0
        self._last_step = 0

    @torch.inference_mode()
    def proc_eof(self):
        """Drain the BSVD lookahead at end of stream: the last SHIFT_NUM
        frames are still inside the network when the source ends."""
        # ring entries precede the drained lookahead in stream order
        yield from super().proc_eof()
        if not self.denoising or not getattr(self, "_frames_seen", 0):
            return
        k = min(self._frames_seen, bsvd.SHIFT_NUM)
        tail = np.stack(self._tail_frames[-k:])
        if k < bsvd.SHIFT_NUM:
            pad = np.zeros((bsvd.SHIFT_NUM - k,) + tail.shape[1:], tail.dtype)
            tail = np.concatenate([pad, tail], axis=0)
        # drain in live-micro-batch-sized chunks
        bs = max(1, min(self.batch_size, bsvd.SHIFT_NUM))
        total = -(-bsvd.SHIFT_NUM // bs) * bs
        if total > bsvd.SHIFT_NUM:
            tail = np.concatenate(
                [tail, np.zeros((total - bsvd.SHIFT_NUM,) + tail.shape[1:], tail.dtype)]
            )
        if self._frames_seen >= bsvd.SHIFT_NUM:
            # warm steps leave the skip1/skip2 FIFOs in ring order; the
            # flush steps pop in FIFO order
            self._den_state = bsvd.ring_to_fifo_state(self._den_state, self.bsvd_cfg)
        outs = []
        for i in range(0, total, bs):
            out, self._den_state = flush_batch_denoise(
                self._sr_apply, self._params, self._den_state,
                _to_device(self.device, tail[i : i + bs]), self._frames_seen, self.spec, self.bsvd_cfg,
            )
            outs.append(_HostCopy(out))
        drained = np.concatenate([o.numpy() for o in outs])[: bsvd.SHIFT_NUM][bsvd.SHIFT_NUM - k :]
        mask = np.asarray(self._tail_real[-k:], bool)
        prof = Profiler()
        prof.start("recoder.output")
        prof.start("upscaler.upscale")
        yield UpscalerQueueEntry(
            frames=drained[mask],
            audio_segment=None,
            step=self._last_step + 1,
            elapsed=0.0,
            last_modified=time.time(),
            profiler=prof,
        )

    @torch.inference_mode()
    def upscale_dispatch(self, frames):
        """frames: (N, H, W, 3) uint8 -> (host copy in flight, N)."""
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (N, H, W, 3), got {frames.shape}")
        n = len(frames)
        if self.denoising:
            if n < self.batch_size:
                # padded frames advance the BSVD stream state; for a live
                # stream the repeated tail frame is benign
                pad = np.repeat(frames[-1:], self.batch_size - n, axis=0)
                frames = np.concatenate([frames, pad], axis=0)
            out, self._den_state = upscale_batch_denoise(
                self._sr_apply, self._params, self._den_state, _to_device(self.device, frames),
                self.spec, self.bsvd_cfg,
                # steady state: once SHIFT_NUM frames are in, every warm-up
                # window mask is an identity
                warm=self._frames_seen >= bsvd.SHIFT_NUM,
                sr_sub_batch=self._sr_sub,
                tsm_pair=self.tsm_pair,
                # the service owns its state: warm steps write the new
                # frames into its skip rings without copying them
                inplace=True,
            )
            self._frames_seen += len(frames)
            # remember the fed frames (pads included: they advance the BSVD
            # timeline) so proc_eof can drain the in-flight tail; pads are
            # flagged and dropped at emission
            real = [True] * n + [False] * (len(frames) - n)
            self._tail_frames = (self._tail_frames + list(frames))[-bsvd.SHIFT_NUM:]
            self._tail_real = (self._tail_real + real)[-bsvd.SHIFT_NUM:]
            return _HostCopy(out), n

        if n < self.batch_size:
            pad = np.repeat(frames[-1:], self.batch_size - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        out = upscale_multi(self._sr_apply, self._sr_params, _to_device(self.device, frames), self.spec)
        return _HostCopy(out), n


class EgvsrUpscalerService(BaseUpscalerService):
    """Frame-recurrent EGVSR service (reference egvsr_upscaler.py:145-212).

    device: 'cuda' (default) or 'cpu'; a CUDA device on a host without
    CUDA raises here, at construction.  cut_threshold: the scene-cut skip
    (egvsr.frnet_step), on by default for a live stream.  chunked: run
    each micro-batch as one egvsr_upscale_chunk (FNet batched over the
    micro-batch) instead of one egvsr_upscale_step per frame.  The
    micro-batch's outputs are stacked on the device and leave through one
    host copy."""

    def __init__(
        self,
        lr_level: int = 0,
        on_queue=None,
        output_shape: tuple[int, int] | None = (1440, 2560),
        weights: str | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        cfg: egvsr.EGVSRConfig | None = None,
        pix_fmt: str = "rgb24",
        cut_threshold: float | None = 0.12,
        chunked: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(name="EgvsrUpscaler")
        self.device = resolve_device(device)
        self.pix_fmt = pix_fmt
        self.lr_shape = LR_LEVELS[lr_level]
        self.output_shape = output_shape
        self.on_queue = on_queue
        self.weights = weights
        self.compute_dtype = compute_dtype
        self.cfg = cfg
        self.cut_threshold = cut_threshold
        self.chunked = chunked

    def proc_init(self) -> None:
        # idempotent, so callers can build the service on their own thread
        # before start() without resetting the recurrence
        if getattr(self, "_initialized", False):
            return
        if self.weights is not None:
            sd = torch_import.load_state_dict(self.weights)
            if self.cfg is None:
                # shape-match the checkpoint (the reference's production
                # file is nb=10/BD, the FRNet class default nb=16/BI)
                self.cfg = egvsr.config_from_torch(sd)
                log.info("EGVSR config from checkpoint: %s", (self.cfg,))
            params = egvsr.from_torch(sd, self.cfg)
        else:
            if self.cfg is None:
                self.cfg = egvsr.PRODUCTION
            log.warning("no EGVSR weights given; using random init")
            params = egvsr.init_params(torch.Generator().manual_seed(0), self.cfg)
        # weights live on the device in the compute dtype, cast once
        self._params = torch_import.to_tensors(params, self.device, self.compute_dtype)
        self.spec = UpscaleSpec(
            lr_shape=self.lr_shape,
            output_shape=self.output_shape,
            compute_dtype=self.compute_dtype,
            pix_fmt=self.pix_fmt,
        )
        h, w = self.lr_shape
        self._state = egvsr.init_recurrent_state(1, h, w, self.cfg, self.compute_dtype, self.device)
        log.info("model loaded (egvsr %s, chunked=%s, device=%s)", self.cfg, self.chunked, self.device)
        self._initialized = True

    @torch.inference_mode()
    def upscale_dispatch(self, frames):
        """frames: (N, H, W, 3) uint8 -> (host copy in flight, N)."""
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (N, H, W, 3), got {frames.shape}")
        x = _to_device(self.device, frames)
        kw = dict(cut_threshold=self.cut_threshold, cfg=self.cfg)
        if self.chunked and len(frames) > 1:
            out, self._state = egvsr_upscale_chunk(self._params, self._state, x, self.spec, **kw)
        else:
            outs = []
            for i in range(len(frames)):
                o, self._state = egvsr_upscale_step(self._params, self._state, x[i : i + 1],
                                                    self.spec, **kw)
                outs.append(o)
            out = torch.cat(outs)
        return _HostCopy(out), len(frames)
