"""The benchmark's source and sink against the command lines of the
program's stream/ffmpeg_io.py: frames in order and as the seed makes
them, the stamps, the kept frames."""

import json
import os
import subprocess
import sys
import time

import numpy as np

from portbench.content import Scene
from portbench.live import _ReadyServer, _SinkServer, fake_ffmpeg_wrapper
from sharkshark_tpu_torch.stream import ffmpeg_io

H, W = 24, 40


def _env(**specs):
    return {**os.environ, **{k: json.dumps(v) for k, v in specs.items()}}


def test_source_emits_the_seeded_frames_paced_and_stamped(tmp_path):
    fake, src = fake_ffmpeg_wrapper(tmp_path)
    ready = _ReadyServer()
    started = time.time_ns()
    spec = {"seed": 2**33 + 5, "pan": [1, 3], "sigma": 6.0, "fps": 20, "lead_ns": 50_000_000,
            "seconds_ns": 500_000_000, "ready": "\0" + ready.name, "stamps": str(tmp_path / "s.npz")}
    cmd = ffmpeg_io.decode_video_cmd(str(src), W, H, 20, binary=str(fake))
    out = subprocess.run(cmd, env=_env(PORTBENCH_SOURCE=spec), capture_output=True, timeout=60, check=True).stdout
    t0 = ready.wait(timeout=10)
    frames = np.frombuffer(out, np.uint8).reshape(-1, H, W, 3)
    assert len(frames) == 10                        # 0.5 s at 20 frames/s
    scene = Scene(spec["seed"], H, W, pan=(1, 3), sigma=6.0)
    np.testing.assert_array_equal(frames, scene.frames(range(10)))
    with np.load(tmp_path / "s.npz") as z:
        stamps, ready_ns = z["stamps"], int(z["ready_ns"])
    assert started < ready_ns == t0 - 50_000_000  # the source opened the window once it was ready
    assert stamps.shape == (10, 2)
    np.testing.assert_array_equal(stamps[:, 0], [t0 + i * 50_000_000 for i in range(10)])
    assert (stamps[:, 1] >= stamps[:, 0]).all()
    # the scene pans: frame 1 is frame 0 moved 3 px left and 1 up, up to the noise
    diff = frames[1, :-1, :-3].astype(int) - frames[0, 1:, 3:].astype(int)
    assert np.abs(diff).mean() < 12 and np.abs(frames[1].astype(int) - frames[0]).mean() > 0


def test_unpaced_source_stops_at_the_window_close(tmp_path):
    fake, src = fake_ffmpeg_wrapper(tmp_path)
    ready = _ReadyServer()
    spec = {"seed": 1, "pan": [1, 3], "sigma": 6.0, "fps": 0, "lead_ns": 50_000_000, "seconds_ns": 200_000_000,
            "ready": "\0" + ready.name, "stamps": str(tmp_path / "s.npz")}
    cmd = ffmpeg_io.decode_video_cmd(str(src), W, H, 24, binary=str(fake))
    out = subprocess.run(cmd, env=_env(PORTBENCH_SOURCE=spec), capture_output=True, timeout=60, check=True).stdout
    t0 = ready.wait(timeout=10)
    n = len(out) // (H * W * 3)
    with np.load(tmp_path / "s.npz") as z:
        stamps, ready_ns = z["stamps"], int(z["ready_ns"])
    assert ready_ns < t0
    assert n == len(stamps) > 20 and (stamps[:, 0] >= t0).all() and (stamps[:, 0] < t0 + 200_000_000).all()


def test_audio_decode_is_empty(tmp_path):
    fake, src = fake_ffmpeg_wrapper(tmp_path)
    cmd = ffmpeg_io.decode_audio_cmd(str(src), binary=str(fake))
    assert subprocess.run(cmd, capture_output=True, timeout=60, check=True).stdout == b""


def test_sink_stamps_every_frame_and_keeps_a_seeded_sample(tmp_path):
    fake, _ = fake_ffmpeg_wrapper(tmp_path)
    server = _SinkServer()
    spec = {"seed": 7, "keep": 3, "socket": "\0" + server.name}
    fifo = tmp_path / "audio"
    os.mkfifo(fifo)
    cmd = ffmpeg_io.encode_cmd(str(tmp_path / "out.flv"), W, H, 24, str(fifo), binary=str(fake))
    frames = np.random.default_rng(0).integers(0, 256, (9, H, W, 3), dtype=np.uint8)
    p = subprocess.Popen(cmd, stdin=subprocess.PIPE, env=_env(PORTBENCH_SINK=spec))
    for f in frames:
        p.stdin.write(f.tobytes())
    p.stdin.close()
    assert p.wait(timeout=60) == 0
    got = server.wait(timeout=30)
    assert int(got["n"]) == 9 and len(got["arrivals"]) == 9
    assert (np.diff(got["arrivals"]) >= 0).all()
    idx = got["kept_idx"]
    assert len(idx) == 3 and len(set(idx.tolist())) == 3 and idx.max() < 9
    for k, f in zip(idx, got["kept"]):
        np.testing.assert_array_equal(f, frames[k])
    assert not any(tmp_path.glob("out.flv"))        # the sink writes nothing


def test_content_is_fast_enough_for_an_unpaced_cell():
    scene = Scene(3, 720, 1280, pan=(1, 3), sigma=6.0)
    buf = np.empty((720, 1280, 3), np.uint8)
    t = time.perf_counter()
    for i in range(100):
        scene.frame(i, buf)
    rate = 100 / (time.perf_counter() - t)
    assert rate > 3 * 100, rate                    # at least 3x the fastest cell's ~90 frames/s
    assert sys.getsizeof(scene.tiled) < 64 << 20
