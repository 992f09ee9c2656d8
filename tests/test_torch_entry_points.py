"""The port's other entry points on the CPU against the JAX package's:
EsrganUpscalerService's 'fsrcnn' and model-zoo branches (SR only, and
one zoo model with the BSVD denoiser), main/upscale_image.py on a small
PNG, and main/pipeline_folder.py with the child CLI replaced by a
recorder.  Weights are seeded and written as .pth files in the reference
key layout, which both packages load through their own from_torch.

Tolerance: uint8 outputs may differ by 1, where a float32 value that
differs in its last bits (sums in another order) falls on the other side
of an integer step of the truncating cast.  No test reaches a download:
the zoo's downloader is replaced by one that fails."""

import inspect
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sharkshark_tpu.main import upscale_image as jupscale_image
from sharkshark_tpu.runtime import EOF as JEOF
from sharkshark_tpu.upscale.service import EsrganUpscalerService as JService
from sharkshark_tpu.upscale.service import UpscalerQueueEntry as JEntry
from sharkshark_tpu_torch.main import pipeline_folder, upscale_image
from sharkshark_tpu_torch.models import fsrcnn, rrdbnet, srvgg, zoo
from sharkshark_tpu_torch.runtime import EOF
from sharkshark_tpu_torch.upscale import service as service_mod
from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService, UpscalerQueueEntry

ROOT = Path(__file__).resolve().parent.parent
BSVD_PTH = ROOT / "weights" / "minted" / "bsvd-derived-32.pth"
LR, OUT = (12, 20), (24, 40)


@pytest.fixture(autouse=True)
def no_download(monkeypatch):
    def refuse(url, path):
        raise ConnectionError("downloads are off in the tests")

    monkeypatch.setattr(zoo, "_download", refuse)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded checkpoints: FSRCNN with its deconv drawn 100x wider than the
    reference's init and a 0.5 bias (otherwise its output is a near-
    constant), realesr-animevideov3 and RealESRGAN_x4plus_anime_6B."""
    d = tmp_path_factory.mktemp("zoo")
    fp = fsrcnn.init_params(torch.Generator().manual_seed(20))
    fp["deconv"] = {"w": fp["deconv"]["w"] * 100, "b": torch.full((1,), 0.5)}
    sds = {
        "fsrcnn": fsrcnn.to_torch(fp),
        "realesr-animevideov3": srvgg.to_torch(srvgg.init_params(torch.Generator().manual_seed(21),
                                                                 srvgg.ANIMEVIDEO_V3)),
        "RealESRGAN_x4plus_anime_6B": rrdbnet.to_torch(rrdbnet.init_params(torch.Generator().manual_seed(22),
                                                                           rrdbnet.X4PLUS_ANIME_6B)),
    }
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(d / f"{name}.pth")
        torch.save({"params": sd}, paths[name])
    return paths


def _assert_u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _frames(n, seed):
    """Frames at twice the LR size (the step area-resizes them)."""
    return np.random.default_rng(seed).integers(0, 256, (n, 2 * LR[0], 2 * LR[1], 3), dtype=np.uint8)


def _drive(svc, entry_cls, eof_cls, jobs):
    out = []
    svc.on_queue = out.append
    svc.start()
    for i, frames in enumerate(jobs):
        svc.push_job(entry_cls(frames=frames, step=i), timeout=60)
    svc.push_eof()
    assert svc.wait_eof(timeout=300)
    svc.join(timeout=60)
    assert not svc.is_alive and svc._error is None, svc._error
    assert isinstance(out[-1], eof_cls)
    return np.concatenate([np.asarray(e.frames) for e in out[:-1]])


# ---------------------------------------------------------------- service


@pytest.mark.parametrize("model", ["fsrcnn", "realesr-animevideov3", "RealESRGAN_x4plus_anime_6B"])
def test_sr_only_service_matches_jax(weights, model):
    kw = dict(upscaler_model=model, lr_level=0, denoising=False, batch_size=2, output_shape=OUT,
              weights=weights[model])
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, device="cpu", **kw)
    jsvc = JService(compute_dtype=jnp.float32, **kw)
    tsvc.lr_shape = jsvc.lr_shape = LR
    jobs = [_frames(2, 30), _frames(1, 31)]  # a full micro-batch, then a padded tail
    got = _drive(tsvc, UpscalerQueueEntry, EOF, jobs)
    want = _drive(jsvc, JEntry, JEOF, jobs)
    assert got.shape == (3, *OUT, 3)
    assert got.std() > 5, "the output frames are flat"
    _assert_u8_close(got, want)


def test_zoo_denoise_service_matches_jax(weights):
    """realesr-animevideov3 behind the BSVD denoiser (the repo's minted
    BSVD-32): 2 micro-batches of 4, then the EOF drain of the lookahead."""
    kw = dict(upscaler_model="realesr-animevideov3", lr_level=0, denoising=True, denoise_rate=0.75,
              batch_size=4, output_shape=OUT, weights=weights["realesr-animevideov3"],
              denoise_weights=str(BSVD_PTH))
    tsvc = EsrganUpscalerService(compute_dtype=torch.float32, device="cpu", **kw)
    jsvc = JService(compute_dtype=jnp.float32, **kw)
    tsvc.lr_shape = jsvc.lr_shape = LR
    jobs = [_frames(4, 32), _frames(4, 33)]
    got = _drive(tsvc, UpscalerQueueEntry, EOF, jobs)
    want = _drive(jsvc, JEntry, JEOF, jobs)
    assert got.shape == (8 + 8, *OUT, 3)
    _assert_u8_close(got, want)


@pytest.mark.parametrize("model,conv_stack,want", [
    ("realesrgan", None, srvgg.DEFAULT_CONV_STACK),
    ("realesr-animevideov3", None, srvgg.DEFAULT_CONV_STACK),
    ("realesr-general-x4v3", 2, 2),
    ("fsrcnn", None, 0),
    ("RealESRGAN_x2plus", 0, 0),
])
def test_service_resolves_conv_stack_for_the_model_that_runs(model, conv_stack, want):
    svc = EsrganUpscalerService(upscaler_model=model, conv_stack=conv_stack, device="cpu")
    assert svc.conv_stack == want
    assert svc.scale == (2 if model == "RealESRGAN_x2plus" else 4)


def test_service_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(ValueError, match="no SRVGG body"):
        EsrganUpscalerService(upscaler_model="fsrcnn", conv_stack=1, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        EsrganUpscalerService(upscaler_model="RealESRGAN_x8", device="cpu")
    # a weights file the caller named and that is absent is never replaced
    # by seeded weights
    svc = EsrganUpscalerService(upscaler_model="realesr-animevideov3", weights=str(tmp_path / "absent.pth"),
                                denoising=False, device="cpu")
    with pytest.raises(FileNotFoundError):
        svc.proc_init()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EsrganUpscalerService(upscaler_model="fsrcnn")


def test_zoo_service_without_weights_falls_back_to_seeded(tmp_path, monkeypatch):
    """No weights named and none in the weight directory: the download
    fails and the service runs seeded weights with a warning, as the JAX
    service does."""
    monkeypatch.setenv("SHARKSHARK_WEIGHT_DIR", str(tmp_path))
    warnings = []
    monkeypatch.setattr(service_mod.log, "warning", lambda msg, *args: warnings.append(msg % args))
    svc = EsrganUpscalerService(upscaler_model="realesr-animevideov3", denoising=False, batch_size=1,
                                output_shape=OUT, compute_dtype=torch.float32, device="cpu")
    svc.lr_shape = LR
    svc.proc_init()
    assert len(warnings) == 1 and "using random init" in warnings[0] and "github.com" in warnings[0]
    seeded = srvgg.init_params(torch.Generator().manual_seed(0), srvgg.ANIMEVIDEO_V3)
    assert torch.equal(svc._sr_params["convs"][5]["w"], seeded["convs"][5]["w"])
    assert svc.upscale(_frames(1, 34)).shape == (1, *OUT, 3)


# ----------------------------------------------------------- upscale_image


def _png(tmp_path, h=14, w=18):
    img = np.random.default_rng(35).integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = tmp_path / "in.png"
    Image.fromarray(img).save(path)
    return str(path)


@pytest.mark.parametrize("model,extra", [
    ("fsrcnn", []),
    ("realesr-animevideov3", ["--model", "zoo", "--model-name", "realesr-animevideov3"]),
    ("fsrcnn", ["--tile", "8", "--tile-pad", "2"]),
])
def test_upscale_image_matches_jax(tmp_path, weights, model, extra):
    src = _png(tmp_path)
    argv = ["--input", src, "--weights", weights[model], *extra]
    upscale_image.main(argv + ["--output", str(tmp_path / "port.png"), "--device", "cpu"])
    jupscale_image.main(argv + ["--output", str(tmp_path / "jax.png")])
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert got.shape == (56, 72, 3)
    assert got.std() > 5, "the output is flat"
    _assert_u8_close(got, np.asarray(Image.open(tmp_path / "jax.png")))


def test_upscale_array_runs_on_cuda_unless_asked():
    assert inspect.signature(upscale_image.upscale_array).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            upscale_image.upscale_array(np.zeros((4, 4, 3), np.float32))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            upscale_image.main(["--input", "x.png", "--output", "y.png"])


# --------------------------------------------------------- pipeline_folder


def test_pipeline_folder_runs_the_port_cli_and_skips_done_outputs(tmp_path, monkeypatch, capsys):
    for name in ("a.mp4", "b.MKV", "c.webm", "notes.txt", "[SS4] b.flv"):
        (tmp_path / name).write_bytes(b"")
    runs = []
    monkeypatch.setattr(pipeline_folder.subprocess, "run", lambda cmd, **kw: runs.append((cmd, kw)))
    pipeline_folder.main(["--dir", str(tmp_path), "--fps", "12", "--model", "fsrcnn", "--device", "cpu"])
    assert [cmd[cmd.index("--url") + 1] for cmd, _ in runs] == [str(tmp_path / "a.mp4"), str(tmp_path / "c.webm")]
    cmd, kw = runs[0]
    assert cmd[:3] == [sys.executable, "-m", "sharkshark_tpu_torch.main.upscaler"]
    assert cmd[cmd.index("--output-file") + 1] == str(tmp_path / "[SS4] a.flv")
    assert "--no-frame-skips" in cmd and cmd[cmd.index("--fps") + 1] == "12.0"
    assert cmd[-4:] == ["--model", "fsrcnn", "--device", "cpu"]
    assert kw == {"check": True}
    assert "skip (exists)" in capsys.readouterr().out
