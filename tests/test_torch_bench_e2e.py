"""The port's paced end-to-end bench (sharkshark_tpu_torch/tools/
bench_e2e.py) on the CPU at a tiny ladder (LR 16x32 -> 32x64, as
tests/test_torch_pipeline.py drives the CLI), through the real thread
stages and tests/fake_ffmpeg.py: every row present and finite, the frame
accounting (live + dropped = source frames, the denoise path's EOF drain
counted apart and written to the sink), and the refusal to run on the
CPU unless asked.  Rates on the CPU are no device numbers: the bench's
rows carry "card": null there."""

import json
import math

import numpy as np
import pytest
import torch

from sharkshark_tpu_torch import pipeline as pipeline_mod
from sharkshark_tpu_torch.stream import grabber
from sharkshark_tpu_torch.tools import bench_e2e
from sharkshark_tpu_torch.upscale import levels
from sharkshark_tpu_torch.upscale import service as service_mod

LR, OUT = (16, 32), (32, 64)
ROWS = ["e2e_sustained_fps", "drop_pct", "latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
        "time_to_first_frame_ms", "source_fps", "unpaced_ceiling_fps"]


@pytest.fixture
def tiny_ladder(monkeypatch):
    monkeypatch.setattr(service_mod, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setattr(pipeline_mod, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setitem(grabber.QUALITY_RESOLUTION, "720p60", (LR[1], LR[0]))


@pytest.mark.parametrize("argv,denoise", [
    # paced slowly: 24 frames in 1-s windows of two whole micro-batches,
    # so the drain holds no padding frame
    (["--seconds", "3", "--fps", "8"], True),
    (["--seconds", "1", "--fps", "auto", "--no-denoise"], False),
])
def test_bench_rows_and_frame_accounting(tiny_ladder, tmp_path, argv, denoise):
    sink, out_json = tmp_path / "out.raw", tmp_path / "rows.json"
    rows = bench_e2e.run([*argv, "--device", "cpu", "--output-file", str(sink), "--json-out", str(out_json)])
    assert [r["metric"] for r in rows] == ROWS
    assert json.loads(out_json.read_text()) == rows
    by = {r["metric"]: r for r in rows}
    for r in rows:
        assert isinstance(r["value"], float) and math.isfinite(r["value"]), r
        assert r["device"] == "cpu" and r["card"] is None and r["denoise"] == denoise
    acct = by["drop_pct"]
    n = acct["frames_in"]
    source_fps = by["source_fps"]["value"]
    assert n == int(float(argv[1]) * source_fps) > 0
    assert acct["frames_live"] + acct["frames_dropped"] == n
    assert acct["sink_dropped"] == 0
    assert by["drop_pct"]["value"] == pytest.approx(100.0 * acct["frames_dropped"] / n)
    if argv[3] == "auto":
        assert source_fps == max(1.0, round(0.9 * by["unpaced_ceiling_fps"]["value"], 1))
    else:
        assert acct["frames_dropped"] == 0 and source_fps == 8.0
    assert acct["frames_drained"] == (min(acct["frames_live"], 16) if denoise else 0)
    assert by["latency_p50_ms"]["value"] <= by["latency_p95_ms"]["value"] <= by["latency_p99_ms"]["value"]
    assert by["latency_p50_ms"]["samples"] > 0 and by["time_to_first_frame_ms"]["value"] > 0
    assert by["e2e_sustained_fps"]["value"] > 0 and by["unpaced_ceiling_fps"]["value"] > 0
    ceiling = by["unpaced_ceiling_fps"]
    assert ceiling["frames_in"] == ceiling["frames_live"] == int(float(argv[1]) * bench_e2e.NOMINAL_FPS)
    # every live and drained frame of the paced pass reached the sink
    frames_out = acct["frames_live"] + acct["frames_drained"]
    assert sink.stat().st_size == frames_out * OUT[0] * OUT[1] * 3


def test_reset_stream_restarts_the_denoise_stream(tiny_ladder):
    """A service warmed up and then reset emits what a fresh one does."""
    from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService

    frames = np.random.default_rng(0).integers(0, 256, (4, *LR, 3), dtype=np.uint8)
    kw = dict(batch_size=4, output_shape=OUT, compute_dtype=torch.float32, device="cpu")
    fresh, warmed = EsrganUpscalerService(**kw), EsrganUpscalerService(**kw)
    for svc in (fresh, warmed):
        svc.proc_init()
    for _ in range(5):
        warmed.upscale(np.zeros_like(frames))
    warmed.reset_stream()
    assert warmed._frames_seen == 0 and warmed._tail_frames == []
    for _ in range(5):  # cold chunks, then warm ones
        np.testing.assert_array_equal(warmed.upscale(frames), fresh.upscale(frames))


def test_bench_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_e2e.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_e2e.run(["--seconds", "1"])
