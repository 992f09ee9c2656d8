"""Paced, buffered restream output (a copy of the JAX package's
stream/output.py, behaviour unchanged).

Rebuild of TwitchBufferedOutputStream (reference src/stream/twitch_stream/
output_stream.py:353-556): ordered frame/audio buffers drained at exactly
`fps` so the encoder sees a constant-rate stream regardless of upstream
jitter, repeating the last frame when the buffer runs dry.

Design change: the reference spawns a *new* threading.Timer per frame
(output_stream.py:388-427), which drifts and costs a thread per tick. Here
each channel has ONE daemon pacer thread with an absolute monotonic
deadline schedule — no drift accumulation, no thread churn.

Twitch ingest lookup is kept (get_closest_ingest, output_stream.py:268-274)
but any dest URL/file works; see ffmpeg_io.RawStreamSink for the encoder
process itself.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Optional

import numpy as np

from ..utils import get_logger
from .ffmpeg_io import AUDIO_RATE, RawStreamSink

__all__ = ["BufferedOutputStream", "get_closest_ingest"]

log = get_logger("stream.output")

BUFFER_QSIZE = 64  # reference output_stream.py:351


def get_closest_ingest(stream_key: str) -> str:
    """Twitch ingest endpoint lookup (reference output_stream.py:268-274)."""
    import requests

    ingests = requests.get(
        "https://ingest.twitch.tv/api/v2/ingests", timeout=10
    ).json()["ingests"]
    closest = ingests[0]
    log.info("streaming to closest ingest: %s", closest["name"])
    return closest["url_template"].format(stream_key=stream_key)


class _PacedChannel:
    """Ordered bounded buffer + one pacer thread writing at a fixed period."""

    def __init__(self, name: str, period: float, write, maxsize: int = BUFFER_QSIZE,
                 underrun_fill=None):
        self.name = name
        self.period = period
        self.write = write
        self.maxsize = maxsize
        # on underrun the video channel repeats its last frame (freeze-
        # frame, correct), but audio must NOT replay the previous PCM
        # segment (audible stutter/echo) — underrun_fill maps the last
        # item to a silence item of the same shape
        self.underrun_fill = underrun_fill
        self._heap: list[tuple[int, int, object]] = []
        self._seq = 0
        self._lock = threading.Condition()
        self._last = None
        self._stop = False
        self._sent = 0
        self._underruns = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"pacer-{name}"
        )

    def start(self) -> None:
        self._thread.start()

    def put(self, item, counter: int | None = None) -> bool:
        """Queue an item for paced sending; False if the buffer is full
        (caller decides whether that's a dropped frame)."""
        with self._lock:
            if len(self._heap) >= self.maxsize:
                return False
            if counter is None:
                counter = self._seq
            heapq.heappush(self._heap, (counter, self._seq, item))
            self._seq += 1
            self._lock.notify()
            return True

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)

    @property
    def stats(self) -> dict:
        return {"sent": self._sent, "underruns": self._underruns}

    def stop(self, drain: bool = True) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout=5)
        if not drain:
            return
        # flush whatever is still buffered so close() doesn't lose frames
        while True:
            with self._lock:
                if not self._heap:
                    return
                _, _, item = heapq.heappop(self._heap)
            try:
                self.write(item)
                self._sent += 1
            except (BrokenPipeError, OSError):
                return

    def _run(self) -> None:
        # wait for the first item so the stream starts aligned
        with self._lock:
            while not self._heap and not self._stop:
                self._lock.wait(timeout=0.1)
        deadline = time.monotonic()
        while True:
            with self._lock:
                if self._stop:
                    return
                if self._heap:
                    _, _, item = heapq.heappop(self._heap)
                    self._last = item
                else:
                    item = self._last
                    if item is not None and self.underrun_fill is not None:
                        item = self.underrun_fill(item)
                    self._underruns += 1
            if item is not None:
                try:
                    self.write(item)
                    self._sent += 1
                except (BrokenPipeError, OSError):
                    log.warning("%s: sink closed, pacer exiting", self.name)
                    return
            deadline += self.period
            delay = deadline - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                # fell behind; resynchronize rather than bursting
                deadline = time.monotonic()


class BufferedOutputStream:
    """Constant-fps encoder feeder with frame/audio reordering buffers.

    API parity with TwitchBufferedOutputStream: send_video_frame(frame,
    frame_counter), send_audio(left, right, frame_counter),
    get_video_frame_buffer_state(), get_audio_buffer_state().
    """

    def __init__(
        self,
        dest: str,
        width: int,
        height: int,
        fps: float,
        enable_audio: bool = True,
        sink: Optional[RawStreamSink] = None,
        realtime: bool = True,
        **sink_kwargs,
    ) -> None:
        self.width, self.height, self.fps = width, height, fps
        self.realtime = realtime
        self.sink = sink or RawStreamSink(
            dest, width, height, fps, enable_audio=enable_audio, **sink_kwargs
        )
        if not realtime:
            # offline/file mode: write-through, no wall-clock pacing and no
            # underrun repeats — every submitted frame lands exactly once
            self._video = None
            self._audio = None
            self._audio_enabled = enable_audio
            return
        self._video = _PacedChannel(
            "video", 1.0 / fps, self.sink.send_video_frame
        )
        self._audio = (
            _PacedChannel(
                "audio",
                1.0 / fps,
                lambda seg: self.sink.send_audio(seg[0], seg[1]),
                underrun_fill=lambda seg: (
                    np.zeros_like(seg[0]), np.zeros_like(seg[1])
                ),
            )
            if enable_audio
            else None
        )
        self._video.start()
        if self._audio:
            self._audio.start()

    def check_proc(self) -> None:
        self.sink.check_proc()

    def send_video_frame(
        self, frame: np.ndarray, frame_counter: int | None = None
    ) -> bool:
        if self._video is None:
            self.sink.send_video_frame(frame)
            return True
        return self._video.put(frame, frame_counter)

    def send_audio(
        self,
        left: np.ndarray,
        right: np.ndarray,
        frame_counter: int | None = None,
    ) -> bool:
        if self._audio is None:
            if not self.realtime and self._audio_enabled:
                self.sink.send_audio(left, right)
            return True
        return self._audio.put((left, right), frame_counter)

    def get_video_frame_buffer_state(self) -> int:
        return self._video.qsize() if self._video else 0

    def get_audio_buffer_state(self) -> int:
        return self._audio.qsize() if self._audio else 0

    @property
    def stats(self) -> dict:
        if self._video is None:
            return {}
        s = {"video": self._video.stats}
        if self._audio:
            s["audio"] = self._audio.stats
        return s

    def close(self) -> None:
        if self._video:
            self._video.stop()
        if self._audio:
            self._audio.stop()
        self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
