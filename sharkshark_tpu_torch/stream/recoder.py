"""Ingest stage service: captures 1-second frame batches + audio segments.

A copy of the JAX package's stream/recoder.py, which imports no JAX.

Rebuild of reference src/stream/recoder.py:26-190 (TwitchRecoder) on the
thread-stage runtime: per tick it grabs `batch_sec*fps` frames from the
image grabber (ffmpeg via grabber.ImageGrabber, YouTube via
youtube.YoutubeImageRecoder), optionally area-resizes to `output_shape`
and stamps a received-count overlay, pairs the batch with one audio
segment (with an optional `audio_skip`-batch delay queue for A/V sync,
reference :138-141), and emits a RecoderEntry. EOF emits the runtime's
EOF sentinel downstream (the reference used frames=None and a TODO).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..runtime import BaseService, Profiler
from ..utils import get_logger

__all__ = ["RecoderEntry", "Recoder"]

log = get_logger("stream.recoder")


@dataclass
class RecoderEntry:
    index: int
    audio_segment: Optional[np.ndarray]
    frames: Optional[np.ndarray]
    fps: float
    profiler: Profiler
    captured_at: float = 0.0  # wall-clock at capture, for true e2e latency


def _overlay_received(frame: np.ndarray, count: int) -> np.ndarray:
    import cv2

    if not frame.flags.writeable or not frame.flags.c_contiguous:
        frame = np.array(frame)  # cv2 needs a writable contiguous buffer
    return cv2.putText(
        frame,
        f"Received: {count} frames",
        (10, 32),
        cv2.FONT_HERSHEY_PLAIN,
        0.5,
        (255, 0, 0),
        1,
    )


class Recoder(BaseService):
    """Self-driving stage: proc loop grabs batches and delivers through
    on_queue / result_queue; push_job is unused (source stage)."""

    def __init__(
        self,
        url: str,
        batch_sec: int = 1,
        fps: float = 24,
        quality: str = "720p60",
        on_queue=None,
        audio_skip: int = 0,
        output_shape: tuple[int, int] | None = None,
        image_grabber=None,
        audio_grabber=None,
        overlay: bool = True,
        max_reconnects: int = 0,
    ) -> None:
        assert isinstance(batch_sec, int)
        super().__init__(name="Recoder")
        self.url = url
        self.batch_sec = batch_sec
        self.fps = fps
        self.quality = quality
        self.on_queue = on_queue
        self.audio_skip = audio_skip
        self.output_shape = output_shape
        self.overlay = overlay
        self.frame_count = 0
        # live sources can drop; the reference dies on EOF (recoder.py:114).
        # max_reconnects > 0 rebuilds the grabbers and keeps capturing.
        self.max_reconnects = max_reconnects
        self.reconnects = 0
        self._image_grabber = image_grabber
        self._audio_grabber = audio_grabber
        self._audio_delay: deque = deque()

    def proc_init(self) -> None:
        if self._image_grabber is None:
            if "youtube" in self.url:
                from .youtube import YoutubeImageRecoder

                self._image_grabber = YoutubeImageRecoder(
                    url=self.url, quality=self.quality, rate=self.fps
                )
            else:
                from .grabber import ImageGrabber

                self._image_grabber = ImageGrabber(
                    self.url, quality=self.quality, fps=self.fps
                ).start()
        if self._audio_grabber is None:
            from .grabber import AudioGrabber

            self._audio_grabber = AudioGrabber(
                self.url, segment_length=self.batch_sec
            ).start()

    # Source stage: ignore the job queue and run our own capture loop.
    def _thread_main(self) -> None:  # overrides BaseService loop
        try:
            self.proc_init()
            index = 0
            tick_times: deque = deque(maxlen=100)
            t = time.time()
            while not self._stop_requested():
                frames = []
                eof = False
                for _ in range(self.batch_sec * int(self.fps)):
                    frame = self._image_grabber.grab()
                    if frame is None:
                        log.info("grabber EOF")
                        eof = True
                        break
                    frame = self._postprocess(frame)
                    frames.append(frame)

                if not frames:
                    if not eof:
                        continue
                    # EOF with an empty tick: straight to reconnect/sentinel
                    if self._handle_eof():
                        continue
                    break

                audio = self._audio_grabber.grab() if self._audio_grabber else None
                if self.audio_skip > 0 and audio is not None:
                    # delay audio by `audio_skip` batches (reference :138-141)
                    while len(self._audio_delay) < self.audio_skip:
                        self._audio_delay.append(audio.copy())
                    self._audio_delay.append(audio)
                    audio = self._audio_delay.popleft()

                tick_times.append(time.time() - t)
                t = time.time()
                entry = RecoderEntry(
                    index=index,
                    audio_segment=audio,
                    frames=np.stack(frames, axis=0),
                    fps=self.fps,
                    profiler=Profiler(),
                    captured_at=time.time(),
                )
                entry.profiler.set(
                    "recoder.capture", sum(tick_times) / len(tick_times)
                )
                entry.profiler.start("recoder.output")
                self._deliver(entry)
                index += 1
                if eof:
                    # the partial last batch above is delivered BEFORE the
                    # sentinel/reconnect — a VOD's tail frames must not be
                    # silently truncated (same drain guarantee as the BSVD
                    # lookahead flush downstream)
                    if self._handle_eof():
                        continue
                    break
        except BaseException as ex:  # noqa: BLE001
            self._error = ex
            self._dead = True
            try:
                self._deliver(self._eof())
            except BaseException:  # noqa: BLE001 — downstream may be dead
                pass
            self._eof_seen.set()
            raise
        finally:
            self._dead = self._error is not None
            self.proc_cleanup()
            self._dispose_grabbers()

    def _handle_eof(self) -> bool:
        """Source EOF: returns True to continue (reconnected), False to
        exit after delivering the EOF sentinel downstream."""
        if self.reconnects < self.max_reconnects and not self._stop_requested():
            self.reconnects += 1
            log.warning(
                "stream EOF; reconnect %d/%d",
                self.reconnects,
                self.max_reconnects,
            )
            self.proc_cleanup()
            self._dispose_grabbers()
            self._image_grabber = None
            self._audio_grabber = None
            try:
                self.proc_init()
                return True
            except Exception as ex:  # noqa: BLE001
                log.error("reconnect failed: %s", ex)
        self._deliver(self._eof())
        self._eof_seen.set()
        return False

    def _eof(self):
        from ..runtime.service import EOF_SENTINEL

        return EOF_SENTINEL

    def _stop_requested(self) -> bool:
        # reuse job_queue as the command channel: any item means 'exit'
        return not self.job_queue.empty()

    def stop(self) -> None:
        if self._started:
            self.job_queue.put(object())
            # unblock a grab() waiting out a source stall: terminate()
            # sets the grabbers' _terminated flag (and kills the decoder
            # process), so the capture loop observes the stop promptly
            # instead of riding out the stall-tolerant wait
            self.proc_cleanup()
            self.join()

    def _postprocess(self, frame: np.ndarray) -> np.ndarray:
        if self.output_shape is not None and frame.shape[:2] != tuple(
            self.output_shape
        ):
            import cv2

            frame = cv2.resize(
                frame,
                dsize=(self.output_shape[1], self.output_shape[0]),
                interpolation=cv2.INTER_AREA,
            )
        if self.overlay:
            frame = _overlay_received(frame, self.frame_count)
            self.frame_count += 1
        return frame

    def proc_cleanup(self) -> None:
        """Stop the grabbers. Cross-thread safe: terminate() only shuts
        the native pump down (stop flags + wakeups) — it does not free
        the ring the run thread's grab() may still be blocked on. The
        run thread frees it via _dispose_grabbers() on its own way out."""
        for g in (self._image_grabber, self._audio_grabber):
            if g is not None:
                try:
                    g.terminate()
                except Exception:  # pragma: no cover
                    pass

    def _dispose_grabbers(self) -> None:
        """Free grabber native resources (pump ring + reader thread).
        RUN-THREAD ONLY: close() destroys the ring a concurrent grab()
        could be waiting on; the control thread's stop() path must go
        through proc_cleanup() instead."""
        for g in (self._image_grabber, self._audio_grabber):
            close = getattr(g, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # pragma: no cover
                    pass
