"""YouTube/VOD ingest: parallel ranged-HTTP chunk download + demux/decode.

A copy of the JAX package's stream/youtube.py, which imports no JAX.

Rebuild of reference src/stream/youtube_recoder/image_recoder.py:14-212:
N worker threads fetch fixed-size byte ranges of the progressive stream
URL concurrently; an assembler reorders them into a contiguous in-memory
stream which PyAV demuxes/decodes; frames are fps-downsampled by index
rounding and served through `grab()`.

The chunk reordering is factored into ChunkAssembler (pure, no network)
so the scheduling logic is unit-testable; `requests` and `av` (PyAV,
optional) are imported lazily, where they are used.
"""

from __future__ import annotations

import io
import queue
import threading
import time
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils import get_logger
from .grabber import QUALITY_RESOLUTION, resolve_stream_url

__all__ = ["ChunkAssembler", "YoutubeImageRecoder"]

log = get_logger("stream.youtube")

CHUNK_SIZE = 200_000          # reference image_recoder.py:22
N_WORKERS = 8                 # :21
SAFE_BUFFER = 500_000         # :20


class ChunkAssembler:
    """Reorders out-of-order (position, bytes) chunks into a contiguous
    prefix. `add` returns the list of newly contiguous chunks, in order."""

    def __init__(self, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = chunk_size
        self.next_position = 0
        self.pending: dict[int, bytes] = {}

    def add(self, position: int, chunk: bytes) -> list[bytes]:
        self.pending[position] = chunk
        ready: list[bytes] = []
        while self.next_position in self.pending:
            c = self.pending.pop(self.next_position)
            ready.append(c)
            self.next_position += self.chunk_size
        return ready


class YoutubeImageRecoder:
    """grab() -> next RGB frame (H, W, 3) uint8, None at EOF."""

    def __init__(
        self,
        url: str,
        quality: str = "720p",
        rate: float = 24,
        chunk_size: int = CHUNK_SIZE,
        n_workers: int = N_WORKERS,
        stream_url: str | None = None,
        content_size: int | None = None,
    ):
        self.rate = rate
        self.chunk_size = chunk_size
        self.width, self.height = QUALITY_RESOLUTION[quality]
        self.stream_url = stream_url or resolve_stream_url(url, quality)
        if content_size is None:
            content_size = int(
                parse_qs(urlparse(self.stream_url).query)["clen"][0]
            )
        self.content_size = content_size

        self.terminated = False
        self.worker_queue: queue.Queue = queue.Queue(maxsize=n_workers)
        self.chunk_queue: queue.Queue = queue.Queue(maxsize=n_workers)
        self.frame_queue: queue.Queue = queue.Queue(maxsize=256)

        self.workers = [
            threading.Thread(target=self._worker_main, daemon=True)
            for _ in range(n_workers)
        ]
        self.thread = threading.Thread(target=self._proc_main, daemon=True)
        self.thread.start()
        for t in self.workers:
            t.start()

    def _fetch_range(self, start: int, end: int) -> bytes | None:
        import requests

        res = requests.get(f"{self.stream_url}&range={start}-{end}", timeout=30)
        if res.status_code == 200:
            return res.content
        log.warning("range fetch failed: %s", res.status_code)
        return None

    def _worker_main(self) -> None:
        while not self.terminated:
            start = self.worker_queue.get()
            if start is None:
                return
            # retry in-worker with backoff: re-putting into the bounded
            # worker_queue can deadlock every worker when fetches fail
            # simultaneously (all blocked in put() on a full queue, none
            # consuming), and a permanently-403 URL must error out, not
            # spin forever
            content = None
            for attempt in range(8):
                content = self._fetch_range(start, start + self.chunk_size - 1)
                if content is not None or self.terminated:
                    break
                time.sleep(min(2.0**attempt * 0.25, 10.0))
            if content is not None:
                self.chunk_queue.put((start, content))
            else:
                log.error("chunk at %d failed after retries; aborting", start)
                self.chunk_queue.put((start, None))  # poison -> _proc_main

    def _proc_main(self) -> None:
        try:
            import av
        except ImportError:
            self.frame_queue.put(None)
            raise RuntimeError("PyAV is required for YouTube/VOD ingest")
        try:
            self._decode_loop(av)
        except BaseException:  # noqa: BLE001
            # ALWAYS deliver the EOF marker: a demux/decode error must not
            # leave grab() blocked forever on an empty queue
            self.frame_queue.put(None)
            raise

    def _decode_loop(self, av) -> None:

        assembler = ChunkAssembler(self.chunk_size)
        stream = io.BytesIO(b"0" * self.content_size)
        stream_position = 0
        container = None
        container_position = 0
        frame_index = 0
        adjusted_index = 0
        scheduled = 0

        while not self.terminated:
            while not self.worker_queue.full() and scheduled < self.content_size:
                self.worker_queue.put(scheduled)
                scheduled += self.chunk_size

            start, content = self.chunk_queue.get()
            if content is None:  # worker gave up on a chunk
                raise RuntimeError(f"VOD chunk fetch failed at offset {start}")
            for chunk in assembler.add(start, content):
                stream.seek(stream_position)
                stream.write(chunk)
                stream_position += len(chunk)
                stream.seek(container_position)
                if container is None:
                    container = av.open(stream, mode="r")
                for packet in container.demux():
                    if packet.size < 1:
                        continue
                    for frame in packet.decode():
                        img = np.array(frame.to_image().convert("RGB"))
                        fps = float(container.streams.video[0].rate)
                        # fps down-sample by index rounding (:160-167)
                        new_adjusted = round(frame_index / fps * self.rate)
                        if new_adjusted != adjusted_index:
                            self.frame_queue.put(img)
                        adjusted_index = new_adjusted
                        frame_index += 1
                    container_position = stream.tell()
                    if container_position > stream_position - SAFE_BUFFER:
                        break
                container_position = stream.tell()

            if assembler.next_position >= self.content_size:
                self.frame_queue.put(None)
                return

    def grab(self) -> np.ndarray | None:
        return self.frame_queue.get()

    def terminate(self) -> None:
        self.terminated = True

    def join(self) -> None:
        self.thread.join()
