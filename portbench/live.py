"""One run of the live pipeline, built as `python -m
sharkshark_tpu_torch.main.upscaler` builds it, between the benchmark's
own source and sink (portbench/ffmpeg/fake_ffmpeg.py).

    build the pipeline -> warm_up() -> start -> the source, once it is
    ready, opens the window at t0 and emits until t1 = t0 + seconds ->
    EOF -> the drain

The harness wraps the stages' `on_queue` callbacks to log what passes
(capture batches, the service's entries, the Streamer's deliveries) and
takes the stamps of the source and the sink; accounting.py turns them
into frames, carriers and latencies.
"""

from __future__ import annotations

import faulthandler
import io
import json
import os
import queue
import socket
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .accounting import DRAIN
from .registry import HERE, ROOT

__all__ = ["RunLogs", "run_pipeline", "fake_ffmpeg_wrapper"]

LEAD_NS = 50_000_000  # from the source's ready stamp to the window: the harness hears of t0 before it
READY_TIMEOUT_S = 60.0


@dataclass
class RunLogs:
    t0_ns: int = 0
    t1_ns: int = 0
    t_end_ns: int = 0
    setup_s: float = 0.0
    warmup_s: float = 0.0
    captures: list = field(default_factory=list)    # (frames, captured_at s)
    service: list = field(default_factory=list)     # (step | DRAIN, frames)
    delivered: list = field(default_factory=list)   # (step | DRAIN, frames)
    spans: list = field(default_factory=list)       # (delivery ns, profiler data) of live deliveries
    host: list = field(default_factory=list)        # (label, start ns, end ns) on the service thread
    fetched: list = field(default_factory=list)     # (end ns, frames) of each fetch of a step's output
    source: np.ndarray | None = None
    source_ready_ns: int = 0
    sink: dict | None = None
    memory_peak_bytes: int = 0
    batch: int = 4
    skipped_frames: int = 0
    trace_events: list | None = None
    trace_window: tuple[int, int] | None = None


def fake_ffmpeg_wrapper(work: Path) -> tuple[Path, Path]:
    """An executable that runs the benchmark's fake ffmpeg, and a dummy
    input file for the grabbers (a local path passes URL resolution)."""
    fake = work / "ffmpeg"
    script = HERE / "ffmpeg" / "fake_ffmpeg.py"
    fake.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{script}" "$@"\n')
    fake.chmod(0o755)
    src = work / "source.mp4"
    src.write_bytes(b"")
    return fake, src


@contextmanager
def _environ(**values: str):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build_pipeline(config: dict, traffic: dict, src: Path, sink_path: Path, device: str):
    """The pipeline as main/upscaler.py's main() builds it for
    `--model <config model> --quality .. --fps .. [--no-frame-skips]
    --lr-level .. --hr-level .. --denoise-rate .. --output-file ..
    --no-overlay [--batch-size ..]` and the weights of the config."""
    from sharkshark_tpu_torch.pipeline import UpscalePipeline
    from sharkshark_tpu_torch.upscale.levels import HR_LEVELS
    from sharkshark_tpu_torch.upscale.service import EgvsrUpscalerService

    kwargs = {}
    if config["model"] == "egvsr":
        kwargs["upscaler"] = EgvsrUpscalerService(
            lr_level=config["lr_level"], output_shape=HR_LEVELS[config["hr_level"]],
            weights=str(ROOT / config["weights"]), pix_fmt="rgb24", device=device, mesh=None)
    else:
        kwargs.update(upscaler_model=config["model"], weights=str(ROOT / config["weights"]), weights_wdn=None,
                      denoise_weights=str(ROOT / config["denoise_weights"]), mesh=None)
    return UpscalePipeline(
        url=str(src), fps=traffic["capture_fps"], quality=config["quality"],
        frame_skips=bool(traffic["frame_skips"]), output_file=str(sink_path), lr_level=config["lr_level"],
        hr_level=config["hr_level"], denoising=bool(config.get("denoise", False)),
        denoise_rate=float(config.get("denoise_rate", 1.0)), pix_fmt="rgb24", audio_skip=0,
        batch_size=traffic.get("batch_size"), device=device, overlay=False, **kwargs)


def _hook(stage, log: list, record):
    """Wrap stage.on_queue so that every entry is logged before it goes on."""
    inner = stage.on_queue

    def on_queue(entry):
        if getattr(entry, "frames", None) is not None:
            record(entry, log)
        inner(entry)

    stage.on_queue = on_queue


def _step(entry) -> int:
    return DRAIN if not entry.captured_at else entry.step


class _Listener:
    """An abstract-namespace Unix socket (no file) that takes one
    message: all the bytes of one connection, parsed by `parse`."""

    def __init__(self, parse) -> None:
        self.name = f"portbench-{os.getpid()}-{time.time_ns()}"
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind("\0" + self.name)
        self.sock.listen(1)
        self.parse = parse
        self.result = None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        conn, _ = self.sock.accept()
        with conn:
            chunks = []
            while True:
                b = conn.recv(1 << 22)
                if not b:
                    break
                chunks.append(b)
        self.result = self.parse(b"".join(chunks))

    def wait(self, timeout: float):
        self.thread.join(timeout)
        self.sock.close()
        return self.result


def _npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class _SinkServer(_Listener):
    """Where the sink sends its stamps and kept frames at EOF."""

    def __init__(self) -> None:
        super().__init__(_npz)


class _ReadyServer(_Listener):
    """Where the source sends the window's opening, t0 (ns), once its
    scene is made."""

    def __init__(self) -> None:
        super().__init__(lambda b: int.from_bytes(b, "little", signed=True) if len(b) == 8 else None)


def _wrap_host(svc, logs: RunLogs) -> None:
    """Log the service thread's host work (dispatch, fetch) for the idle
    gaps' labels; undone by _unwrap_host (the wrappers close over the
    service)."""
    for name, label in (("upscale_dispatch", "service.dispatch"), ("_fetch", "service.fetch")):
        inner = getattr(svc, name)

        def wrapped(*a, _inner=inner, _label=label, **k):
            t = time.time_ns()
            try:
                return _inner(*a, **k)
            finally:
                t_end = time.time_ns()
                logs.host.append((_label, t, t_end))
                if _label == "service.fetch":
                    logs.fetched.append((t_end, int(a[1] if len(a) > 1 else k["n"])))

        setattr(svc, name, wrapped)


def _unwrap_host(svc) -> None:
    for name in ("upscale_dispatch", "_fetch"):
        svc.__dict__.pop(name, None)


def _stop(pipe) -> None:
    """Stop every stage and its ffmpeg processes, each even where another
    fails to stop (a stage stuck mid-queue, or a Streamer blocked on an
    encoder that stopped reading: the encoder is killed, so its write
    fails and the thread ends)."""
    for stage in (pipe.recoder, pipe.upscaler, pipe.streamer):
        try:
            stage.stop()
        except queue.Full:
            print(f"portbench: {type(stage).__name__} did not take its stop", file=sys.stderr, flush=True)
            stage.proc_cleanup()
    sink = getattr(getattr(pipe.streamer, "videostream", None), "sink", None)
    if pipe.streamer.is_alive and sink is not None:
        print("portbench: the Streamer is still writing; killing the encoder", file=sys.stderr, flush=True)
        sink.proc.kill()
        pipe.streamer.join()


def _sleep_until(t_ns: int) -> None:
    while (left := t_ns - time.time_ns()) > 0:
        time.sleep(min(left / 1e9, 0.05))


def run_pipeline(config: dict, traffic: dict, seed: int, seconds: float, work: Path, *, device: str = "cuda",
                 trace: bool = False, t_start_ns: int | None = None, after_build=None) -> RunLogs:
    """One run; returns its logs.  t_start_ns: time.time_ns() at the
    process's start (set-up runs from there to the window's opening).
    after_build(pipe): a hook for tests, called once the pipeline is
    built and warmed up."""
    import torch

    logs = RunLogs()
    t_start_ns = time.time_ns() if t_start_ns is None else t_start_ns
    fake, src = fake_ffmpeg_wrapper(work)
    from sharkshark_tpu_torch.stream import native

    native.load_library()  # the Recoder's frame pump, built once a checkout: in set-up, not in the window
    with _environ(SHARKSHARK_FFMPEG=str(fake)):
        pipe = build_pipeline(config, traffic, src, work / "sink.flv", device)
        svc = pipe.upscaler
        logs.batch = pipe.small_batch_size
        t = time.monotonic()
        svc.warm_up()
        if device == "cuda":
            torch.cuda.synchronize()
        logs.warmup_s = time.monotonic() - t
        if after_build is not None:
            after_build(pipe)

        _hook(pipe.recoder, logs.captures, lambda e, log: log.append((len(e.frames), float(e.captured_at))))
        _hook(svc, logs.service, lambda e, log: log.append((_step(e), len(e.frames))))

        def delivered(e, log):
            log.append((_step(e), len(e.frames)))
            if e.captured_at:
                logs.spans.append((time.time_ns(), dict(e.profiler.data)))

        _hook(pipe.streamer, logs.delivered, delivered)
        _wrap_host(svc, logs)
        if trace:
            _profiler_warm_up(device)
        server, ready = _SinkServer(), _ReadyServer()
        window_ns = int(seconds * 1e9)
        stamps = work / "source_stamps.npz"
        source_spec = {"seed": int(seed), "pan": traffic["pan"], "sigma": traffic["noise_sigma"],
                       "fps": traffic["source_fps"], "lead_ns": LEAD_NS, "seconds_ns": window_ns,
                       "ready": "\0" + ready.name, "stamps": str(stamps)}
        sink_spec = {"seed": int(seed) ^ 0x5EED, "keep": traffic["check_frames"], "socket": "\0" + server.name}
        env = {"PORTBENCH_SOURCE": json.dumps(source_spec), "PORTBENCH_SINK": json.dumps(sink_spec)}
        try:
            with _environ(**env):
                pipe.start()
                t0 = ready.wait(timeout=READY_TIMEOUT_S)
                if t0 is None:
                    raise RuntimeError(f"the source did not open the window within {READY_TIMEOUT_S} s")
                t1 = t0 + window_ns
                logs.t0_ns, logs.t1_ns = t0, t1
                logs.setup_s = (t0 - t_start_ns) / 1e9
                if trace:
                    logs.trace_window, logs.trace_events = _traced(t0, t1, seconds, device)
                _sleep_until(t1)
                if not pipe.streamer.wait_eof(float(traffic["drain_s"])):
                    # the stream never drained: say where every thread is
                    print(f"portbench: the pipeline did not drain within {traffic['drain_s']} s "
                          "of the window's close", file=sys.stderr, flush=True)
                    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                logs.t_end_ns = time.time_ns()
        finally:
            _stop(pipe)
            _unwrap_host(svc)
        for stage in (pipe.recoder, svc, pipe.streamer):
            stage.check_proc()
        logs.skipped_frames = pipe.skipped_frames
        logs.sink = server.wait(timeout=60)
        if logs.sink is None or "error" in logs.sink:
            raise RuntimeError(f"the sink failed: {None if logs.sink is None else logs.sink['error']}")
        with np.load(stamps) as z:
            logs.source, logs.source_ready_ns = z["stamps"], int(z["ready_ns"])
        if device == "cuda":
            logs.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        svc.close()
    del pipe, svc
    return logs


def _traced(t0: int, t1: int, seconds: float, device: str):
    """torch.profiler over the window's last min(10 s, half) of device
    activity; returns ((start ns, end ns), [(name, start ns, end ns)])
    of every device operation.  It stops at the window's close, so its
    own processing falls after the window."""
    from torch.profiler import ProfilerActivity, profile

    length = int(min(10.0, seconds / 2) * 1e9)
    _sleep_until(t1 - length)
    acts = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    a = time.time_ns()
    _sleep_until(t1)
    b = time.time_ns()
    prof.stop()
    return (a, b), device_events(prof, device)


def _profiler_warm_up(device: str) -> None:
    """A first profile of nothing: the profiler's first start sets up
    CUPTI, which takes seconds, and must not fall in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        if device == "cuda":
            torch.cuda.synchronize()


def device_events(prof, device: str) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the trace's device operations
    (kernels, copies, sets), on the wall clock as kineto stamps them."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device == "cuda" else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        out.append((e.name(), int(start), int(start + dur)))
    return out
