"""The port's EGVSR steps and service, its pipeline and its CLI, on the
CPU: the steps and EgvsrUpscalerService(device='cpu') against the JAX
package's step with the repo's minted EGVSR weights at LR 16x32, over
several frames so that the recurrence is held too; UpscalePipeline with
fake grabbers and a list sink for both models (as tests/test_pipeline.py
drives the JAX pipeline); and the CLI with --device cpu through
tests/fake_ffmpeg.py, with the output file's size checked.

Tolerance: uint8 outputs may differ by 1, where a float32 value that
differs in its last bits (sums in another order) falls on the other side
of an integer step of the truncating cast."""

import inspect
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharkshark_tpu.models import egvsr as jegvsr
from sharkshark_tpu.models import torch_import as jti
from sharkshark_tpu.upscale import steps as jsteps
from sharkshark_tpu_torch import pipeline as pipeline_mod
from sharkshark_tpu_torch.main import upscaler as cli
from sharkshark_tpu_torch.models import egvsr, fsrcnn, srvgg, zoo
from sharkshark_tpu_torch.pipeline import UpscalePipeline
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.stream import BufferedOutputStream, Recoder, Streamer, grabber
from sharkshark_tpu_torch.upscale import levels, steps
from sharkshark_tpu_torch.upscale import service as service_mod
from sharkshark_tpu_torch.upscale.service import (
    EgvsrUpscalerService,
    EsrganUpscalerService,
    UpscalerQueueEntry,
)

ROOT = Path(__file__).resolve().parent.parent
MINTED = ROOT / "weights" / "minted" / "egvsr-derived-x4.pth"
LR, OUT = (16, 32), (32, 64)


def _assert_u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _frames(n, seed=0):
    """Source frames at twice the LR size (the step area-resizes them),
    with a scene cut at frame 3."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (2 * LR[0], 2 * LR[1], 3), dtype=np.uint8)
    frames = np.stack([np.roll(base, i, axis=1) for i in range(n)])
    frames[3:] = 255 - frames[3:]
    return frames


@pytest.fixture(scope="module")
def minted():
    sd = jti.load_state_dict(str(MINTED))
    jcfg, cfg = jegvsr.config_from_torch(sd), egvsr.config_from_torch(sd)
    return (jegvsr.from_torch(sd, jcfg), jcfg), (egvsr.from_torch(sd, cfg), cfg)


@pytest.fixture(scope="module")
def jax_outputs(minted):
    """The JAX package's per-frame step over 7 frames (the reference)."""
    (jp, jcfg), _ = minted
    spec = jsteps.UpscaleSpec(lr_shape=LR, output_shape=OUT, compute_dtype=jnp.float32)
    step = jax.jit(jsteps.egvsr_upscale_step, static_argnums=(3, 4, 5))
    state = jegvsr.init_recurrent_state(1, *LR, jcfg)
    outs = []
    for f in _frames(7):
        out, state = step(jp, state, jnp.asarray(f[None]), spec, 0.12, jcfg)
        outs.append(np.asarray(out))
    return np.concatenate(outs)


def _spec():
    return steps.UpscaleSpec(lr_shape=LR, output_shape=OUT, compute_dtype=torch.float32)


def test_egvsr_step_matches_jax(minted, jax_outputs):
    _, (tp, cfg) = minted
    state = egvsr.init_recurrent_state(1, *LR, cfg)
    outs = []
    for f in _frames(7):
        out, state = steps.egvsr_upscale_step(tp, state, torch.from_numpy(f[None]), _spec(),
                                              cut_threshold=0.12, cfg=cfg)
        outs.append(out.numpy())
    _assert_u8_close(np.concatenate(outs), jax_outputs)


def test_egvsr_chunk_matches_jax(minted, jax_outputs):
    """Micro-batches of 4 then 3: FNet batched, the recurrence carried
    across the chunks."""
    (jp, jcfg), (tp, cfg) = minted
    frames = _frames(7)
    spec = jsteps.UpscaleSpec(lr_shape=LR, output_shape=OUT, compute_dtype=jnp.float32)
    jstate = jegvsr.init_recurrent_state(1, *LR, jcfg)
    state = egvsr.init_recurrent_state(1, *LR, cfg)
    for a, b in ((0, 4), (4, 7)):
        jo, jstate = jsteps.egvsr_upscale_chunk(jp, jstate, jnp.asarray(frames[a:b]), spec, 0.12, jcfg)
        to, state = steps.egvsr_upscale_chunk(tp, state, torch.from_numpy(frames[a:b]), _spec(),
                                              cut_threshold=0.12, cfg=cfg)
        _assert_u8_close(to, jo)
        _assert_u8_close(to, jax_outputs[a:b])


@pytest.mark.parametrize("chunked", [False, True])
def test_egvsr_service_matches_jax_step(jax_outputs, chunked):
    svc = EgvsrUpscalerService(lr_level=0, output_shape=OUT, weights=str(MINTED),
                               compute_dtype=torch.float32, chunked=chunked, device="cpu")
    svc.lr_shape = LR  # override the ladder for the tiny test
    got = []
    svc.on_queue = got.append
    svc.start()
    frames = _frames(7)
    for i, (a, b) in enumerate(((0, 3), (3, 5), (5, 7))):
        svc.push_job(UpscalerQueueEntry(frames=frames[a:b], step=i), timeout=60)
    svc.push_eof()
    assert svc.wait_eof(timeout=300)
    svc.join(timeout=60)
    assert not svc.is_alive and svc._error is None, svc._error
    assert isinstance(got[-1], EOF)
    assert (svc.cfg.nb, svc.cfg.degradation) == (10, "BI")
    _assert_u8_close(np.concatenate([e.frames for e in got[:-1]]), jax_outputs)


def test_entry_points_default_to_cuda():
    for cls in (EgvsrUpscalerService, EsrganUpscalerService, UpscalePipeline):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert cli.build_parser().parse_args(["--url", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EgvsrUpscalerService()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--url", "x", "--model", "egvsr"])


# ------------------------------------------------------------- pipeline


class FakeImageGrabber:
    def __init__(self, n, h, w):
        self.n, self.h, self.w, self.i = n, h, w, 0

    def grab(self, timeout=None):
        if self.i >= self.n:
            return None
        self.i += 1
        return np.full((self.h, self.w, 3), (self.i * 7) % 256, np.uint8)

    def terminate(self):
        pass


class FakeAudioGrabber:
    def grab(self, timeout=None):
        return np.zeros((4410, 2), np.float32)

    def terminate(self):
        pass


class ListSink:
    def __init__(self):
        self.frames = []
        self.audio = []

    def send_video_frame(self, f):
        self.frames.append(np.array(f))

    def send_audio(self, left, right):
        self.audio.append(left)

    def check_proc(self):
        pass

    def close(self):
        pass


@pytest.mark.parametrize("model", ["egvsr", "realesrgan"])
def test_pipeline_end_to_end_eof_drain(model):
    """24 frames at fps 8 -> 3 captures x 2 micro-batches of 4; EGVSR
    emits every frame once, the denoise path adds its 16 drained
    lookahead frames at EOF."""
    h, w, n = 24, 32, 24
    sink = ListSink()
    # offline write-through: every submitted frame lands exactly once
    stream = BufferedOutputStream("unused", width=2 * w, height=2 * h, fps=1000.0,
                                  enable_audio=True, sink=sink, realtime=False)
    if model == "egvsr":
        upscaler = EgvsrUpscalerService(output_shape=(2 * h, 2 * w), compute_dtype=torch.float32,
                                        cfg=egvsr.EGVSRConfig(nf=16, nb=2), device="cpu")
        want = n
    else:
        from sharkshark_tpu_torch.models import bsvd

        upscaler = EsrganUpscalerService(
            denoising=True, batch_size=4, output_shape=(2 * h, 2 * w), compute_dtype=torch.float32,
            srvgg_cfg=srvgg.SRVGGConfig(num_feat=16, num_conv=2),
            bsvd_cfg=bsvd.BSVDConfig(chns=(8, 16, 24)), device="cpu")
        want = n + 16
    upscaler.lr_shape = (h, w)
    recoder = Recoder(url="fake://", batch_sec=1, fps=8, image_grabber=FakeImageGrabber(n, h, w),
                      audio_grabber=FakeAudioGrabber(), overlay=False)
    streamer = Streamer(resolution=(2 * h, 2 * w), fps=8, output_stream=stream, overlay=False)
    pipe = UpscalePipeline(url="fake://", fps=8, frame_skips=False, recoder=recoder,
                           upscaler=upscaler, streamer=streamer, report_interval=1e9)
    pipe.start()
    pipe.join(timeout=120)
    assert len(sink.frames) == want
    assert sink.frames[0].shape == (2 * h, 2 * w, 3) and sink.frames[0].dtype == np.uint8
    assert pipe.frame_step == 6 and pipe.skipped_batches == 0
    assert upscaler._error is None


# ------------------------------------------------------------------ CLI


def test_cli_parser_surface():
    args = cli.build_parser().parse_args([
        "--url", "https://twitch.tv/example", "--quality", "720p60", "--fps", "24",
        "--denoise-rate", "0.5", "--hr-level", "1", "--lr-level", "2", "--audio-queue", "2",
        "--output-file", "out.flv", "--no-frame-skips", "--device", "cpu", "--no-overlay",
    ])
    assert args.fps == 24 and args.hr_level == 1 and args.no_frame_skips and args.no_overlay
    assert args.model == "realesrgan" and args.device == "cpu"


@pytest.mark.parametrize("argv", [["--mesh", "1,2,3"]])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    """Every flag of the JAX CLI is ported (--mesh since the multi-device
    slice, tests/test_torch_parallel.py); a --mesh that names no DATA,SPATIAL
    shape is the parser's error."""
    with pytest.raises(SystemExit):
        cli.main(["--url", "x", "--device", "cpu", *argv])
    assert "--mesh 1,2,3" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["fsrcnn_x3", "realesr-animevideov4"])
def test_cli_refuses_an_unknown_model(name, capsys):
    """As the JAX CLI: the error names the model and lists the known ones."""
    with pytest.raises(SystemExit):
        cli.main(["--url", "x", "--device", "cpu", "--model", name])
    err = capsys.readouterr().err
    assert f"--model {name!r} unknown" in err
    for known in ("realesrgan", "fsrcnn", "egvsr", *zoo.ZOO):
        assert repr(known) in err


class _RecordingPipeline:
    """Stands in for UpscalePipeline: records what the CLI builds it with."""

    built = []

    def __init__(self, **kw):
        self.built.append(kw)
        self.recoder = self.upscaler = self.streamer = self

    def start(self):
        pass

    def join(self):
        pass

    def check_proc(self):
        pass


@pytest.mark.parametrize("name", ["fsrcnn", *zoo.ZOO])
def test_cli_takes_every_model_name(name, monkeypatch):
    """fsrcnn and every zoo name get past parsing to the pipeline, on the
    service's model switch."""
    monkeypatch.setattr(pipeline_mod, "UpscalePipeline", _RecordingPipeline)
    _RecordingPipeline.built.clear()
    cli.main(["--url", "x", "--device", "cpu", "--model", name])
    (kw,) = _RecordingPipeline.built
    assert kw["upscaler_model"] == name and kw["device"] == "cpu" and "upscaler" not in kw


@pytest.mark.parametrize("model,extra_frames", [("egvsr", 0), ("realesrgan", 8), ("fsrcnn", 8),
                                                ("realesr-animevideov3", 8)])
def test_cli_through_fake_ffmpeg(tmp_path, monkeypatch, model, extra_frames):
    """The CLI on the CPU with tests/fake_ffmpeg.py standing in for
    ffmpeg, at a tiny ladder: 8 frames in, every frame out once (plus the
    denoise path's drained lookahead, min(8, 16)).  fsrcnn and the zoo's
    realesr-animevideov3 run seeded weights written to a .pth."""
    weights = []
    if model in ("fsrcnn", "realesr-animevideov3"):
        g = torch.Generator().manual_seed(9)
        sd = (fsrcnn.to_torch(fsrcnn.init_params(g)) if model == "fsrcnn"
              else srvgg.to_torch(srvgg.init_params(g, srvgg.ANIMEVIDEO_V3)))
        torch.save(sd, tmp_path / "sr.pth")
        weights = ["--weights", str(tmp_path / "sr.pth")]
    monkeypatch.setattr(zoo, "_download", lambda url, path: pytest.fail(f"download of {url}"))
    fake = tmp_path / "ffmpeg"
    fake.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{ROOT / "tests" / "fake_ffmpeg.py"}" "$@"\n')
    fake.chmod(0o755)
    src = tmp_path / "source.mp4"
    src.write_bytes(b"")
    monkeypatch.setenv("SHARKSHARK_FFMPEG", str(fake))
    monkeypatch.setenv("FAKE_FFMPEG_FRAMES", "8")
    monkeypatch.setattr(service_mod, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setattr(pipeline_mod, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setitem(grabber.QUALITY_RESOLUTION, "tiny", (LR[1], LR[0]))
    out = tmp_path / "out.raw"
    cli.main(["--url", str(src), "--quality", "tiny", "--fps", "4", "--no-frame-skips",
              "--output-file", str(out), "--device", "cpu", "--model", model, "--no-overlay", *weights])
    assert os.path.getsize(out) == (8 + extra_frames) * OUT[0] * OUT[1] * 3
