"""Stream ingest: URL resolution + frame/audio grabbers (a copy of the
JAX package's stream/grabber.py, behaviour unchanged).

Rebuild of src/stream/twitch_realtime_handler/ (twitchhandler.py:20-150,
twitchgrabber.py:12-115): streamlink resolves a Twitch/YouTube URL to an
HLS stream (local file paths pass through), then an ffmpeg subprocess
decodes to raw RGB24 frames / float32 PCM which `grab()` returns as
ndarrays. streamlink is optional at import (absent on the test
images); file-based ingest works without it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import get_logger
from .ffmpeg_io import (
    AUDIO_RATE,
    RawFrameSource,
    decode_audio_cmd,
    decode_video_cmd,
)

__all__ = ["QUALITY_RESOLUTION", "resolve_stream_url", "ImageGrabber", "AudioGrabber"]

log = get_logger("stream.grabber")

# reference twitchgrabber.py:72-82
QUALITY_RESOLUTION: dict[str, tuple[int, int]] = {
    "160p": (320, 160),
    "360p": (640, 360),
    "480p": (854, 480),
    "720p": (1280, 720),
    "720p48": (1280, 720),
    "720p60": (1280, 720),
    "1080p": (1920, 1080),
    "1080p60": (1920, 1080),
    "source": (1920, 1080),
}


def resolve_stream_url(url: str, quality: str = "720p60") -> str:
    """streamlink URL resolution with local-file passthrough
    (reference twitchhandler.py:26-60)."""
    if os.path.exists(url):
        log.info("given path is a file: %s", url)
        return url
    try:
        from streamlink.session import Streamlink
    except ImportError as e:  # pragma: no cover - env without streamlink
        raise RuntimeError(
            "streamlink is required to resolve live-stream URLs; "
            "pass a local file path instead"
        ) from e
    sess = Streamlink()
    streams = sess.streams(url)
    if not streams:
        raise ValueError(f"no stream available for {url}")
    log.info("found resolutions: %s", list(streams.keys()))
    if quality not in streams and quality == "audio_only":
        for alt in ("audio_opus", "audio"):
            if alt in streams:
                quality = alt
                break
        else:
            quality = "360p"
    if quality not in streams:
        raise ValueError(
            f"stream lacks quality {quality!r} (has {list(streams.keys())})"
        )
    stream = streams[quality]
    if hasattr(stream, "substreams"):
        return stream.substreams[0].url
    return stream.url


class ImageGrabber(RawFrameSource):
    """Raw RGB24 frame grabber at a fixed fps (reference TwitchImageGrabber,
    twitchgrabber.py:69-115)."""

    def __init__(
        self,
        url: str,
        quality: str = "720p60",
        fps: float = 24,
        blocking: bool = True,
        binary: str | None = None,
        resolved_url: Optional[str] = None,
    ) -> None:
        if quality not in QUALITY_RESOLUTION:
            raise ValueError(f"unrecognized quality {quality!r}")
        width, height = QUALITY_RESOLUTION[quality]
        stream_url = resolved_url or resolve_stream_url(url, quality)
        super().__init__(
            cmd=decode_video_cmd(stream_url, width, height, fps, binary),
            payload_bytes=width * height * 3,
            shape=(height, width, 3),
            dtype=np.uint8,
            blocking=blocking,
        )
        self.width, self.height, self.fps = width, height, fps


class AudioGrabber(RawFrameSource):
    """PCM audio grabber returning (rate*segment_length, channels) float32
    segments (reference TwitchAudioGrabber, twitchgrabber.py:13-66)."""

    def __init__(
        self,
        url: str,
        segment_length: float = 1.0,
        rate: int = AUDIO_RATE,
        channels: int = 2,
        blocking: bool = True,
        binary: str | None = None,
        resolved_url: Optional[str] = None,
    ) -> None:
        stream_url = resolved_url or resolve_stream_url(url, "audio_only")
        n_samples = int(rate * segment_length)
        super().__init__(
            cmd=decode_audio_cmd(stream_url, rate, channels, "f32le", binary),
            payload_bytes=n_samples * channels * 4,
            shape=(n_samples, channels),
            dtype=np.float32,
            blocking=blocking,
        )
        self.rate, self.channels = rate, channels
