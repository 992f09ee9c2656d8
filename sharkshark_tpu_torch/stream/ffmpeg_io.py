"""ffmpeg pipe transport: raw-frame decode source and encode sink.

A copy of the JAX package's stream/ffmpeg_io.py (host code, behaviour
unchanged), itself a rewrite of the reference's two ffmpeg touchpoints:

- decode: HLS/file -> rawvideo rgb24 frames / PCM audio on stdout
  (src/stream/twitch_realtime_handler/twitchgrabber.py:91-104,48-62),
- encode: rawvideo stdin + PCM FIFO -> H.264 FLV -> RTMP
  (src/stream/twitch_stream/output_stream.py:115-191).

Differences by design:
- `libx264` replaces `h264_nvenc` (the encoder runs on dedicated host
  cores, as in the JAX package).
- The binary is injectable (`binary=` / SHARKSHARK_FFMPEG) so tests run a
  fake rawvideo-speaking process instead of requiring ffmpeg.
- The audio FIFO gets a unique temp path per stream instead of the
  reference's shared hard-coded /tmp/audiopipe (output_stream.py:250).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading
import queue
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "ffmpeg_binary",
    "decode_video_cmd",
    "decode_audio_cmd",
    "encode_cmd",
    "RawFrameSource",
    "RawStreamSink",
]

AUDIO_RATE = 44100


def ffmpeg_binary() -> str:
    return os.environ.get("SHARKSHARK_FFMPEG", "ffmpeg")


def decode_video_cmd(
    url: str, width: int, height: int, fps: float, binary: str | None = None
) -> list[str]:
    """Raw RGB24 frame decode (reference twitchgrabber.py:91-104)."""
    return [
        binary or ffmpeg_binary(),
        "-i", url,
        "-tune", "fastdecode",
        "-threads", "8",
        "-f", "image2pipe",
        "-r", f"{fps}",
        "-pix_fmt", "rgb24",
        "-s", f"{width}x{height}",
        "-vcodec", "rawvideo",
        "-",
    ]


def decode_audio_cmd(
    url: str,
    rate: int = AUDIO_RATE,
    channels: int = 2,
    fmt: str = "f32le",
    binary: str | None = None,
) -> list[str]:
    """PCM audio decode (reference twitchgrabber.py:48-62)."""
    return [
        binary or ffmpeg_binary(),
        "-i", url,
        "-f", fmt,
        "-loglevel", "quiet",
        "-acodec", f"pcm_{fmt}",
        "-ar", str(rate),
        "-ac", str(channels),
        "-",
    ]


def encode_cmd(
    dest: str,
    width: int,
    height: int,
    fps: float,
    audio_fifo: str | None,
    crf: int = 21,
    preset: str = "veryfast",
    binary: str | None = None,
    pix_fmt: str = "rgb24",
) -> list[str]:
    """H.264 FLV encode (reference output_stream.py:115-191, libx264 for
    NVENC; cq 21 -> crf 21, GOP 2 s, aac audio kept).  pix_fmt='yuv420p'
    takes device-converted planar frames (ops.to_yuv420): half the raw
    bytes and no swscale colorspace stage on the host."""
    cmd = [
        binary or ffmpeg_binary(),
        "-loglevel", "error",
        "-y",
        "-analyzeduration", "1",
        "-f", "rawvideo",
        "-r", f"{fps}",
        "-vcodec", "rawvideo",
        "-s", f"{width}x{height}",
        "-pix_fmt", pix_fmt,
        "-thread_queue_size", "4096",
        "-i", "-",
    ]
    if audio_fifo is not None:
        cmd += [
            "-ar", str(AUDIO_RATE),
            "-ac", "2",
            "-f", "s16le",
            "-thread_queue_size", "4096",
            "-i", audio_fifo,
        ]
    else:
        # -shortest: anullsrc is infinite — without it the encoder never
        # exits on video-stdin EOF (close() would SIGKILL it after 10 s,
        # truncating muxer-buffered tail frames and appending silence)
        cmd += ["-f", "lavfi", "-i",
                f"anullsrc=channel_layout=stereo:sample_rate={AUDIO_RATE}",
                "-shortest"]
    cmd += [
        "-c:v", "libx264",
        "-crf", str(crf),
        "-preset", preset,
        "-bufsize:v", "100M",
        "-r", f"{fps}",
        "-s", f"{width}x{height}",
        "-g", str(int(fps * 2)),
        "-pix_fmt", "yuv420p",
        "-acodec", "aac",
        "-bufsize", "128k",
        "-map", "0:v",
        "-map", "1:a",
        "-f", "flv",
        "-flvflags", "no_duration_filesize",
        dest,
    ]
    return cmd


@dataclass
class RawFrameSource:
    """Subprocess emitting fixed-size payloads on stdout; a reader thread
    fills a bounded FIFO and `grab()` pops one payload as an ndarray
    (reference _TwitchHandlerGrabber, twitchhandler.py:80-150)."""

    cmd: Sequence[str]
    payload_bytes: int
    shape: tuple[int, ...]
    dtype: type = np.uint8
    queue_size: int = 1000
    blocking: bool = True
    use_native: bool | None = None  # None = auto (native if buildable)

    _proc: subprocess.Popen | None = field(default=None, init=False)
    _fifo: queue.Queue = field(default=None, init=False)
    _thread: threading.Thread | None = field(default=None, init=False)
    _terminated: bool = field(default=False, init=False)
    _pump: object = field(default=None, init=False)

    def start(self) -> "RawFrameSource":
        self._proc = subprocess.Popen(
            list(self.cmd),
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            bufsize=10**8,
        )
        if self.use_native is not False:
            # native ring-buffer reader (native/framepump.cpp): frames move
            # from the pipe into preallocated slots off the GIL
            try:
                from .native import NativePump

                self._pump = NativePump(
                    self._proc.stdout.fileno(),
                    self.shape,
                    self.dtype,
                    capacity=min(self.queue_size, 64),
                )
                return self
            except Exception:
                if self.use_native is True:
                    raise
        self._fifo = queue.Queue(maxsize=self.queue_size)
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        return self

    def _reader(self) -> None:
        stdout = self._proc.stdout
        while not self._terminated:
            payload = stdout.read(self.payload_bytes)
            if len(payload) < self.payload_bytes:
                self._fifo.put(None)  # EOF marker
                return
            self._fifo.put(payload)

    def grab(self, timeout: float | None = 30) -> np.ndarray | None:
        """Next payload as an array; None on EOF (or, non-blocking, when
        the FIFO is momentarily empty).

        A read timeout is a STALL, not EOF: while the decoder process is
        alive we keep waiting in 1 s slices (the reference's pipe read
        blocks indefinitely — treating an ad-break/CDN stall as EOF
        would tear the pipeline down mid-broadcast).  `timeout` bounds
        only the residual wait once the process has exited or
        terminate() was called."""
        pump = self._pump  # snapshot: close() nulls the attribute
        if pump is not None:
            if not self.blocking and pump.depth == 0:
                return None
            while True:
                out = pump.grab(1.0)
                if out is not None:
                    return out
                if self._terminated or pump.eof:
                    return None
                if self._proc is not None and self._proc.poll() is not None:
                    return pump.grab(timeout or 30)  # drain grace
        if not self.blocking and self._fifo.empty():
            return None
        while True:
            try:
                payload = self._fifo.get(timeout=1.0)
                break
            except queue.Empty:
                if self._terminated:
                    return None
                if self._proc is not None and self._proc.poll() is not None:
                    try:
                        payload = self._fifo.get(timeout=timeout)
                    except queue.Empty:
                        return None
                    break
        if payload is None:
            return None
        return np.frombuffer(payload, self.dtype).reshape(self.shape)

    @property
    def depth(self) -> int:
        if self._pump is not None:
            return self._pump.depth
        return self._fifo.qsize() if self._fifo else 0

    def terminate(self) -> None:
        """Stop the source. Safe from ANY thread: the native pump is only
        shut down here (stop flags + wakeups) — the grabbing thread may
        still be blocked inside pump_grab, and destroying the ring under
        it would be a use-after-free. close() frees the native pump."""
        self._terminated = True
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if self._pump is not None:
            self._pump.shutdown()

    def close(self) -> None:
        """Terminate AND free the native pump. Must run on the grabbing
        thread (or after it has exited): pump_destroy deletes the ring a
        concurrent grab() could still be waiting on."""
        self.terminate()
        pump, self._pump = self._pump, None
        if pump is not None:
            # subprocess is dead -> reader sees EOF -> join is safe
            pump.terminate()


class RawStreamSink:
    """Encode subprocess: raw frames on stdin, PCM s16le on a private FIFO
    (reference TwitchOutputStream.reset + send_*, output_stream.py:103-266).

    `check_proc()` reports encoder death by raising BrokenPipeError so the
    owner can restart the stream, instead of the reference's process-group
    SIGTERM (output_stream.py:81-89)."""

    def __init__(
        self,
        dest: str,
        width: int,
        height: int,
        fps: float,
        enable_audio: bool = True,
        crf: int = 21,
        preset: str = "veryfast",
        binary: str | None = None,
        pix_fmt: str = "rgb24",
    ) -> None:
        self.dest = dest
        self.width, self.height, self.fps = width, height, fps
        self.pix_fmt = pix_fmt
        self._frame_shape = (
            (height, width, 3) if pix_fmt == "rgb24" else (height * 3 // 2, width)
        )
        self.enable_audio = enable_audio
        self._audio_fifo_path: str | None = None
        self._audio_fd: int | None = None
        if enable_audio:
            d = tempfile.mkdtemp(prefix="sharkshark_audio_")
            self._audio_fifo_path = os.path.join(d, "audiopipe")
            os.mkfifo(self._audio_fifo_path)
        self.cmd = encode_cmd(
            dest, width, height, fps, self._audio_fifo_path,
            crf=crf, preset=preset, binary=binary, pix_fmt=pix_fmt,
        )
        self.proc = subprocess.Popen(
            self.cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            bufsize=8 * 1024 * 1024,
        )
        self._lock = threading.Lock()

    def check_proc(self) -> None:
        if self.proc.poll() is not None:
            raise BrokenPipeError(
                f"encoder exited with {self.proc.returncode}"
            )

    def send_video_frame(self, frame: np.ndarray) -> None:
        """frame: (H, W, 3) rgb24 or (H*3/2, W) yuv420p uint8 (float [0,1]
        accepted and converted)."""
        self.check_proc()
        assert frame.shape == self._frame_shape, (frame.shape, self._frame_shape)
        if frame.dtype != np.uint8:
            frame = np.clip(255 * frame, 0, 255).astype(np.uint8)
        with self._lock:
            self.proc.stdin.write(frame.tobytes())

    def send_audio(self, left: np.ndarray, right: np.ndarray) -> None:
        """Interleaved stereo PCM in [-1, 1] -> s16le into the FIFO
        (reference output_stream.py:235-266)."""
        self.check_proc()
        if self._audio_fifo_path is None:
            return
        if self._audio_fd is None:
            # blocks until the encoder opens the read end
            self._audio_fd = os.open(self._audio_fifo_path, os.O_WRONLY)
        samples = np.column_stack((left, right)).ravel()
        samples = np.clip(32767 * samples, -32767, 32767).astype("<i2")
        os.write(self._audio_fd, samples.tobytes())

    def close(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
            if self._audio_fd is not None:
                os.close(self._audio_fd)
                self._audio_fd = None
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
        finally:
            if self._audio_fifo_path and os.path.exists(self._audio_fifo_path):
                os.unlink(self._audio_fifo_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
