"""Live upscale pipeline orchestrator (a copy of the JAX package's
pipeline.py over the port's services and stream layer).

Rebuild of reference src/sharkshark/pipeline.py:15-170
(TwitchUpscalerPostStreamer): wires recoder -> upscaler -> streamer via
on_queue callbacks (each runs on the producing stage's thread and pushes
into the next stage's bounded queue), splits 1-second capture batches
into micro-batches of min(4, fps) frames, applies the drop-on-full
frame-skip policy, and dumps the travelling Profiler as JSON every 3 s
with queue-depth gauges.

Differences from the reference: stages are threads in one process (no
CUDA shared memory / torch.mp — see runtime.service), frames cross stages
as numpy arrays, and EOF is a real sentinel that drains the pipe (the
reference left this as a TODO, pipeline.py:76).  `device` goes to the
default upscaler service ('cuda' unless the caller asks for 'cpu'; with
a `mesh=` among the upscaler's keywords, the mesh's kind);
`overlay=False` turns off the recoder's and streamer's text overlays,
the only place besides a host resize where the stream layer needs cv2.
"""

from __future__ import annotations

import json
import math
import queue
import time
import weakref

from .runtime import EOF
from .runtime.profiler import Profiler
from .stream import Recoder, RecoderEntry, Streamer, StreamerEntry
from .upscale.levels import HR_LEVELS
from .upscale.service import EsrganUpscalerService, UpscalerQueueEntry
from .utils import get_logger

__all__ = ["UpscalePipeline"]

log = get_logger("pipeline")


def _weak(method):
    """`method` called through a weak reference to its pipeline: a stage
    that holds the pipeline's callback does not keep the pipeline alive,
    so a dropped pipeline, its stages and its upscaler's graphs are freed
    without the cycle collector."""
    ref = weakref.WeakMethod(method)

    def call(entry):
        bound = ref()
        if bound is not None:
            bound(entry)

    return call


class UpscalePipeline:
    def __init__(
        self,
        url: str,
        fps: float = 12,
        quality: str = "720p60",
        frame_skips: bool = True,
        output_file: str | None = "rtmp://127.0.0.1/live",
        lr_level: int = 3,
        hr_level: int = 0,
        denoising: bool = True,
        denoise_rate: float = 1.0,
        pix_fmt: str = "rgb24",
        audio_skip: int = 0,
        report_interval: float = 3.0,
        latency_target: float | None = 4.0,
        batch_size: int | None = None,
        recoder: Recoder | None = None,
        upscaler=None,
        streamer: Streamer | None = None,
        device: str = "cuda",
        overlay: bool = True,
        **upscaler_kwargs,
    ) -> None:
        self.url = url
        self.fps = fps
        self.frame_skips = frame_skips
        # reference micro-batch: min(4, fps) (pipeline.py:31); an explicit
        # batch_size (e.g. 8 for the denoise throughput configuration,
        # BASELINE.md round 3) trades one extra capture window of latency
        # for BSVD chunk amortization
        self.small_batch_size = batch_size or min(4, int(fps))
        self.report_interval = report_interval
        # latency-target shedding (seconds, None disables): when the
        # pipeline is oversubscribed (slow model or host link), queued
        # batches are dropped OLDEST-first and the admission depth is
        # scaled to latency_target x measured service rate, so capture->
        # delivery latency stays bounded near the target instead of
        # queue_depth/service_rate (39 s at 3.8 fps with depth-32 queues).
        # The reference's drop-newest policy keeps the stream maximally
        # *stale* under overload; a live stream wants lossy, not late.
        self.latency_target = latency_target
        self._svc_rate = 0.0  # delivered batches/sec (windowed estimate)
        from collections import deque

        self._delivery_times: deque = deque(maxlen=20)

        self.upscaler = upscaler or EsrganUpscalerService(
            lr_level=lr_level,
            on_queue=self.upscaler_on_queue,
            denoising=denoising,
            denoise_rate=denoise_rate,
            batch_size=self.small_batch_size,
            output_shape=HR_LEVELS[hr_level],
            pix_fmt=pix_fmt,
            device=device,
            **upscaler_kwargs,
        )
        self.upscaler.on_queue = _weak(self.upscaler_on_queue)

        self.recoder = recoder or Recoder(
            url=url,
            batch_sec=1,
            fps=fps,
            quality=quality,
            on_queue=self.recoder_on_queue,
            audio_skip=audio_skip,
            output_shape=self.upscaler.lr_shape,
            overlay=overlay,
        )
        self.recoder.on_queue = _weak(self.recoder_on_queue)
        if getattr(self.recoder, "output_shape", None) is None:
            # injected recoders still resize to the processing ladder
            self.recoder.output_shape = self.upscaler.lr_shape

        self.streamer = streamer or Streamer(
            resolution=self.upscaler.output_shape,
            fps=fps,
            output_file=output_file,
            on_queue=self.streamer_on_queue,
            pix_fmt=pix_fmt,
            overlay=overlay,
        )
        self.streamer.on_queue = _weak(self.streamer_on_queue)

        self.frame_step = 0
        self.last_reported = self.last_streamed = time.time()
        self.skipped_batches = 0
        self.skipped_frames = 0  # source frames in the skipped batches
        self._latencies: list[float] = []  # TRUE capture->streamer delivery (s)
        self._intervals: list[float] = []  # gap between streamer deliveries (s)

    # -- stage callbacks (run on the producer's worker thread) -------------

    def recoder_on_queue(self, entry) -> None:
        if isinstance(entry, EOF):
            self.upscaler.push_eof()
            return
        assert isinstance(entry, RecoderEntry)
        sbs = self.small_batch_size
        n_micro = math.ceil(len(entry.frames) / sbs)
        audio = entry.audio_segment
        audio_per = len(audio) // n_micro if audio is not None else 0
        for i in range(n_micro):
            try:
                # each micro-batch carries its OWN Profiler: with the
                # upscaler's in-flight ring, micro-batch k+1's start()
                # can race k's end() on the same region from different
                # stage threads, zeroing the very timings the telemetry
                # exists to report.  Capture-level gauges are copied in.
                prof = Profiler()
                prof.data.update(entry.profiler.data)
                # per-micro-batch queue-wait region (ended by the
                # upscaler service when it picks the job up)
                prof.start("recoder.output")
                prof.start("recoder.output.entry")
                frames = entry.frames[i * sbs : (i + 1) * sbs]
                seg = (
                    audio[i * audio_per : (i + 1) * audio_per]
                    if audio is not None
                    else None
                )
                prof.set("recoder.output.frames.shape", str(frames.shape))
                new_entry = UpscalerQueueEntry(
                    frames=frames,
                    audio_segment=seg,
                    step=self.frame_step,
                    profiler=prof,
                    captured_at=getattr(entry, "captured_at", 0.0) or time.time(),
                )
                self.frame_step += 1
                prof.end("recoder.output.entry")
                if self.frame_skips:
                    self._shed_stale()
                    self.upscaler.push_job_nowait(new_entry)
                else:
                    self.upscaler.push_job(new_entry)
            except queue.Full:
                self.skipped_batches += 1
                self.skipped_frames += len(frames)
                log.info("recoder output skipped (upscaler queue full)")

    def _shed_stale(self) -> None:
        """Drop-oldest admission control on the upscaler queue: keep at
        most latency_target x service_rate batches queued (plus the
        device in-flight ring, already counted against the budget)."""
        if self.latency_target is None or self._svc_rate <= 0:
            return
        budget = self.latency_target * self._svc_rate
        allowed = max(1, int(budget) - getattr(self.upscaler, "inflight_depth", 0))
        q = self.upscaler.job_queue
        while q.qsize() >= allowed:
            try:
                dropped = q.get_nowait()
            except queue.Empty:
                break
            if not isinstance(dropped, UpscalerQueueEntry):
                # control sentinel (EOF/exit) popped: restore it and stop
                # shedding. Re-insertion must never fail — drop entries
                # until it fits (a lost sentinel hangs the join)
                while True:
                    try:
                        q.put_nowait(dropped)
                        break
                    except queue.Full:
                        try:
                            victim = q.get_nowait()
                            if isinstance(victim, UpscalerQueueEntry):
                                self.skipped_batches += 1
                                self.skipped_frames += len(victim.frames)
                        except queue.Empty:
                            pass
                break
            self.skipped_batches += 1
            self.skipped_frames += len(dropped.frames)

    def upscaler_on_queue(self, entry) -> None:
        if isinstance(entry, EOF):
            self.streamer.push_eof()
            return
        assert isinstance(entry, UpscalerQueueEntry)
        try:
            entry.profiler.start("upscaler.output.queue")
            new_entry = StreamerEntry(
                frames=entry.frames,
                audio_segments=entry.audio_segment,
                step=entry.step,
                profiler=entry.profiler,
                captured_at=entry.captured_at,
            )
            entry.profiler.set(
                "upscaler.output.frames.shape", str(entry.frames.shape)
            )
            entry.profiler.end("upscaler.output.queue")
            if self.frame_skips:
                self.streamer.push_job_nowait(new_entry)
            else:
                self.streamer.push_job(new_entry)
        except queue.Full:
            self.skipped_batches += 1
            self.skipped_frames += len(entry.frames)
            log.info("upscaler output skipped (streamer queue full)")

    def streamer_on_queue(self, entry) -> None:
        if isinstance(entry, EOF):
            return
        prof = entry.profiler
        if "upscaler.upscale" in prof.data and len(entry.frames):
            # host-observable work per frame: dispatch + blocking fetch
            # (ring residency excluded — see upscale/service.py)
            work = prof.data["upscaler.upscale"] + prof.data.get(
                "upscaler.fetch", 0.0
            )
            prof.set(
                "upscaler.upscale.per_frame_ms",
                work / len(entry.frames) * 1000,
            )
        # north-star telemetry (BASELINE.md): frame latency percentiles
        # and drop percentage
        import numpy as _np

        now = time.time()
        if getattr(entry, "captured_at", 0.0):
            # true per-batch latency: frames captured -> delivered to streamer
            self._latencies.append(now - entry.captured_at)
            if len(self._latencies) > 1000:
                del self._latencies[:500]
        self._intervals.append(now - self.last_streamed)
        if len(self._intervals) > 1000:
            del self._intervals[:500]
        # service rate feeding the latency-target shedder: a windowed
        # count/timespan (robust to the bursty deliveries the in-flight
        # ring produces, unlike an EMA of 1/interval)
        self._delivery_times.append(now)
        if len(self._delivery_times) >= 2:
            span = self._delivery_times[-1] - self._delivery_times[0]
            if span > 0.5:
                self._svc_rate = (len(self._delivery_times) - 1) / span
        if (time.time() - self.last_reported) > self.report_interval:
            prof.set("upscaler.inputq", self.upscaler.job_queue.qsize())
            prof.set("streamer.inputq", self.streamer.job_queue.qsize())
            prof.set("pipeline.skipped_batches", self.skipped_batches)
            # frame_step already counts every micro-batch, including ones
            # later dropped on a full queue — don't add skips again
            prof.set(
                "pipeline.drop_pct",
                100.0 * self.skipped_batches / max(self.frame_step, 1),
            )
            if self._latencies:
                lat = _np.asarray(self._latencies[-500:])
                prof.set("pipeline.latency_p50_ms", float(_np.percentile(lat, 50)) * 1000)
                prof.set("pipeline.latency_p99_ms", float(_np.percentile(lat, 99)) * 1000)
            if self._intervals:
                iv = _np.asarray(self._intervals[-500:])
                prof.set("pipeline.batch_interval_p50_ms", float(_np.percentile(iv, 50)) * 1000)
                prof.set("pipeline.batch_interval_p99_ms", float(_np.percentile(iv, 99)) * 1000)
            print(json.dumps(prof.data, indent=2, default=str))
            self.last_reported = time.time()
        self.last_streamed = time.time()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self.streamer.start()
        self.upscaler.start()
        self.recoder.start()

    def stop(self) -> None:
        self.recoder.stop()
        self.upscaler.stop()
        self.streamer.stop()

    def join(self, timeout: float | None = None) -> None:
        """Wait until EOF has drained through the last stage (or the
        stages die)."""
        self.streamer.wait_eof(timeout)
        self.recoder.join()
        self.upscaler.join()
        self.streamer.join()
