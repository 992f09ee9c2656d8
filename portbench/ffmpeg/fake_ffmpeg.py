#!/usr/bin/env python3
"""The benchmark's ffmpeg: the source and the sink of the live pipeline.

It speaks the rawvideo / PCM pipe protocol of the exact command lines
that `sharkshark_tpu_torch/stream/ffmpeg_io.py` builds (a frozen copy of
the pattern of `tests/fake_ffmpeg.py`), and is started by the program
through SHARKSHARK_FFMPEG.  Each mode takes its parameters as JSON in an
environment variable the harness sets:

- decode video (`... -vcodec rawvideo -`), PORTBENCH_SOURCE: makes its
  scene, then opens the window itself: t0 = the time it is ready plus
  `lead_ns`, which it sends (8 bytes, little-endian int64, wall clock
  ns) to the harness over the Unix socket `ready`, and t1 = t0 +
  `seconds_ns`.  From t0 until t1 it emits the seeded frames of
  `portbench/content.py` at `-s`: at `fps` frames a second (frame i due
  at t0 + i / fps) or, with fps 0, as fast as the pipe takes them.  It
  writes each frame's due and written times (`stamps`, (n, 2) int64)
  and the time it was ready (`ready_ns`) to the .npz `stamps` when it
  ends.
- decode audio (`-acodec pcm_* ... -`): no segments (EOF at once).
- encode (`... -i - ... dest`), PORTBENCH_SINK: takes in every frame,
  stamps its arrival (wall clock, ns), keeps `keep` frames by reservoir
  sampling seeded from `seed`, and at EOF sends the
  stamps and the kept frames (an .npz) to the harness over the Unix
  socket `socket`.  Nothing else is written.
"""

from __future__ import annotations

import io
import json
import os
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.content import Scene  # noqa: E402


def parse(argv: list[str]) -> tuple[dict, list[str]]:
    """ffmpeg's argv as {option: value} (positionals under '_pos') and the
    list of its -i inputs."""
    args: dict = {}
    inputs: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            inputs.append(argv[i + 1])
            i += 2
            continue
        if a.startswith("-") and a != "-" and i + 1 < len(argv) and not argv[i + 1].startswith("-"):
            args[a] = argv[i + 1]
            i += 2
            continue
        args.setdefault("_pos", []).append(a)
        i += 1
    return args, inputs


def _sleep_until(t_ns: int) -> None:
    while True:
        left = t_ns - time.time_ns()
        if left <= 0:
            return
        time.sleep(min(left, 50_000_000) / 1e9)


def source(w: int, h: int, spec: dict) -> None:
    scene = Scene(spec["seed"], h, w, pan=tuple(spec["pan"]), sigma=spec["sigma"])
    fps = float(spec["fps"])
    n_max = int(spec.get("frames_max") or 1 << 62)
    out = os.fdopen(sys.stdout.fileno(), "wb", buffering=0)
    buf = np.empty((h, w, 3), np.uint8)
    scene.frame(0, buf)
    stamps = []
    ready = time.time_ns()
    t0 = ready + int(spec["lead_ns"])
    t1 = t0 + int(spec["seconds_ns"])
    _send_bytes(spec["ready"], t0.to_bytes(8, "little", signed=True))
    _sleep_until(t0)
    i = 0
    try:
        while i < n_max:
            if fps > 0:
                due = t0 + round(i * 1e9 / fps)
                if due >= t1:
                    break
                scene.frame(i, buf)
                _sleep_until(due)
            else:
                scene.frame(i, buf)
                due = time.time_ns()
                if due >= t1:
                    break
            out.write(memoryview(buf).cast("B"))
            stamps.append((due, time.time_ns()))
            i += 1
    except BrokenPipeError:
        pass
    finally:
        with open(spec["stamps"], "wb") as f:
            np.savez(f, stamps=np.asarray(stamps, np.int64).reshape(-1, 2), ready_ns=np.int64(ready))
        try:
            out.close()
        except BrokenPipeError:
            pass


def _drain(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    while os.read(fd, 65536):
        pass


def _read_exact(fd: int, view: memoryview) -> bool:
    """Fill view from fd; False at EOF before it is full."""
    got = 0
    while got < len(view):
        r = os.readv(fd, [view[got:]])
        if not r:
            return False
        got += r
    return True


def _send_bytes(address: str, data) -> None:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(address)
        s.sendall(data)


def _send(address: str, **arrays) -> None:
    payload = io.BytesIO()
    np.savez(payload, **arrays)
    _send_bytes(address, payload.getbuffer())


def sink(w: int, h: int, inputs: list[str], spec: dict) -> None:
    """Take the frames in; on any failure send the error instead (the
    program gives the encoder no stderr)."""
    try:
        arrays = _sink(w, h, inputs, spec)
    except BaseException as ex:
        _send(spec["socket"], error=np.array(repr(ex)))
        raise
    _send(spec["socket"], **arrays)


def _sink(w: int, h: int, inputs: list[str], spec: dict) -> dict:
    fifo = next((p for p in inputs if p != "-" and os.path.exists(p)), None)
    if fifo:
        threading.Thread(target=_drain, args=(fifo,), daemon=True).start()
    fd = sys.stdin.fileno()
    rng = np.random.default_rng(int(spec["seed"]))
    keep = int(spec["keep"])
    kept_idx = np.full(keep, -1, np.int64)
    kept_frames = np.zeros((keep, h, w, 3), np.uint8)
    frame = np.empty((h, w, 3), np.uint8)
    view = memoryview(frame).cast("B")
    arrivals = []
    n = 0
    while True:
        # reservoir sampling (Algorithm R): frame n is kept with chance keep / (n + 1)
        if not _read_exact(fd, view):
            break
        arrivals.append(time.time_ns())
        slot = n if n < keep else int(rng.integers(0, n + 1))
        if slot < keep:
            kept_frames[slot] = frame
            kept_idx[slot] = n
        n += 1
    order = np.argsort(np.where(kept_idx < 0, 1 << 62, kept_idx))
    return {"arrivals": np.asarray(arrivals, np.int64), "kept_idx": kept_idx[order], "kept": kept_frames[order],
            "n": np.int64(n)}


def main() -> None:
    argv = sys.argv[1:]
    args, inputs = parse(argv)
    pos = args.get("_pos", [])
    if args.get("-vcodec") == "rawvideo" and pos and pos[-1] == "-":
        w, h = map(int, args["-s"].split("x"))
        source(w, h, json.loads(os.environ["PORTBENCH_SOURCE"]))
        return
    if args.get("-acodec", "").startswith("pcm_") and pos and pos[-1] == "-":
        return  # no audio: the grabber sees EOF at once
    if "-" in inputs:
        w, h = map(int, args["-s"].split("x"))
        sink(w, h, inputs, json.loads(os.environ["PORTBENCH_SINK"]))
        return
    sys.exit(f"fake_ffmpeg: unrecognized command: {argv}")


if __name__ == "__main__":
    main()
