"""Egress stage service: feeds upscaled batches into the paced encoder
(a copy of the JAX package's stream/streamer.py, behaviour unchanged).

Rebuild of reference src/stream/streamer.py:15-157 (TwitchStreamer):
per entry it fixes up resolution if needed (area down / bicubic up),
splits the batch audio segment per frame, stamps the processed/skipped
status overlay (reference :134-138), and submits frames + audio into a
BufferedOutputStream which paces them to the encoder at constant fps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..runtime import BaseService, Profiler
from ..utils import get_logger
from .output import BufferedOutputStream

__all__ = ["StreamerEntry", "Streamer"]

log = get_logger("stream.streamer")


@dataclass
class StreamerEntry:
    frames: np.ndarray
    audio_segments: Optional[np.ndarray]
    step: int
    profiler: Profiler
    captured_at: float = 0.0  # wall-clock when source frames were captured


def _overlay_status(frame: np.ndarray, processed: int, skipped: int,
                    color=(0, 255, 0)) -> np.ndarray:
    import cv2

    pct = skipped / (processed + 1e-8) * 100
    if not frame.flags.writeable or not frame.flags.c_contiguous:
        # cv2 needs a writable C-contiguous buffer.  Plain np.array
        # (order='K') is NOT enough for a strided (e.g. planar) view, and
        # plain ascontiguousarray is NOT enough either: it returns
        # read-only inputs unchanged when they are already contiguous.
        frame = np.array(frame, order="C")
    return cv2.putText(
        frame,
        f"[SHARKSHARK] Processed: {processed} frames {skipped} skipped ({pct:.1f}%)",
        (10, 32),
        cv2.FONT_HERSHEY_PLAIN,
        1.0,
        color,
        2,
    )


class Streamer(BaseService):
    def __init__(
        self,
        resolution: tuple[int, int] = (1080, 1920),
        fps: float = 24,
        output_file: str | None = None,
        stream_key: str | None = None,
        on_queue=None,
        output_stream: BufferedOutputStream | None = None,
        overlay: bool = True,
        enable_audio: bool = True,
        realtime: bool | None = None,
        pix_fmt: str = "rgb24",
        **sink_kwargs,
    ) -> None:
        super().__init__(name="Streamer")
        self.pix_fmt = pix_fmt
        self.resolution = resolution
        self.fps = fps
        self.output_file = output_file
        self.stream_key = stream_key
        self.on_queue = on_queue
        self.overlay = overlay
        self.enable_audio = enable_audio
        self.realtime = realtime
        self._sink_kwargs = sink_kwargs
        self.videostream = output_stream
        self.frame_count = 0
        self.last_step = -1
        self.dropped = 0

    def proc_init(self) -> None:
        if self.videostream is None:
            if self.output_file is not None:
                dest = self.output_file
            else:
                from .output import get_closest_ingest

                dest = get_closest_ingest(self.stream_key)
            realtime = self.realtime
            if realtime is None:
                # live pacing for RTMP; write-through for file outputs
                realtime = dest.startswith(("rtmp://", "rtmps://", "udp://"))
            self.videostream = BufferedOutputStream(
                dest,
                width=self.resolution[1],
                height=self.resolution[0],
                fps=self.fps,
                enable_audio=self.enable_audio,
                realtime=realtime,
                pix_fmt=self.pix_fmt,
                **self._sink_kwargs,
            )

    def _fix_resolution(self, frames: np.ndarray) -> np.ndarray:
        """Host-side fallback resize when the upscaler's output shape does
        not match the stream (reference streamer.py:85-90). Normally a
        no-op — the device step already resizes to output_shape."""
        if self.pix_fmt != "rgb24":
            # device-converted planar output (yuv420p): the device step
            # already emits the exact stream resolution
            return frames
        if frames.shape[1:] == (*self.resolution, 3):
            return frames
        import cv2

        interp = (
            cv2.INTER_AREA
            if frames.shape[1] >= self.resolution[0]
            else cv2.INTER_CUBIC
        )
        log.warning("resolution mismatch %s -> %s", frames.shape[1:], self.resolution)
        return np.stack(
            [
                cv2.resize(
                    f, (self.resolution[1], self.resolution[0]), interpolation=interp
                )
                for f in frames
            ]
        )

    def proc_job_recieved(self, job: StreamerEntry) -> StreamerEntry:
        job.profiler.end("upscaler.output")
        if job.step < self.last_step:
            log.warning("job %d queued out of order (last %d)", job.step, self.last_step)

        job.profiler.start("streamer.frames.queue")
        frames = np.asarray(job.frames)
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        # one batched copy if the device returned a strided (planar) view:
        # every downstream consumer (cv2, tobytes) wants C-order
        frames = np.ascontiguousarray(frames)
        frames = self._fix_resolution(frames)
        job.profiler.end("streamer.frames.queue")

        n = len(frames)
        audio = job.audio_segments
        job.profiler.start("streamer.send.queue")
        for i in range(n):
            frame = frames[i]
            if self.overlay:
                job.profiler.start("streamer.send.queue.txt")
                skipped = max(job.step * n - self.frame_count + i, 0)
                # yuv420p frames are planar 2-D: draw luma-only text
                color = (0, 255, 0) if self.pix_fmt == "rgb24" else 235
                frame = _overlay_status(frame, self.frame_count, skipped, color)
                job.profiler.end("streamer.send.queue.txt")

            job.profiler.start("streamer.send.queue.video")
            ok = self.videostream.send_video_frame(frame)
            if not ok:
                self.dropped += 1
            self.frame_count += 1
            job.profiler.end("streamer.send.queue.video")

            if audio is not None and self.enable_audio:
                job.profiler.start("streamer.send.queue.audio")
                seg = audio[i * (len(audio) // n) : (i + 1) * (len(audio) // n)]
                self.videostream.send_audio(seg[:, 0], seg[:, 1])
                job.profiler.end("streamer.send.queue.audio")
        job.profiler.end("streamer.send.queue")

        self.last_step = job.step
        return job

    def proc_cleanup(self) -> None:
        if self.videostream is not None:
            try:
                self.videostream.close()
            except Exception:  # pragma: no cover
                pass
