#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sharkshark_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing is caught):
  1. card and settings: name and power limit (nvidia-smi), TF32 off;
  2. build every CUDA kernel of the paths from the sources, in parallel;
  3. each kernel against its plain PyTorch version on the card at the
     main paths' shapes, with timings (CUDA events, median of 30) beside
     the bound derived from the H100 SXM data sheet and a PyTorch call
     of the same function as a yardstick;
  4. the denoise path at full width: the port's EsrganUpscalerService,
     720p -> 1440p with BSVD-32 denoise and SRVGG general-x4v3 (the
     repo's minted weights), driven as the live pipeline drives it, with
     the kernel launch counts read around that run;
  5. the whole denoise step on the card (bf16) against the port on the
     CPU (float32) at a small size, by PSNR;
  6. the EGVSR path at full width: the port's EgvsrUpscalerService,
     720p -> 1440p (HR frame 2880x5120) with the minted EGVSR weights,
     24 panning frames in micro-batches of 4, one K3 launch per frame;
     then the same frames through the service's chunked route (FNet
     batched over each micro-batch), with its own launch count and its
     output held against the per-frame route's by PSNR;
  7. the EGVSR step on the card (bf16) against the port on the CPU
     (float32) at a small size over 8 frames of the recurrence, by PSNR;
  8. the CLI through the pipeline and stream layer, once with --model
     egvsr and once with the default denoise realesrgan, fed 24 frames
     by tests/fake_ffmpeg.py, with the output file's size checked;
then one JSON line of kernel numbers, the card's name and power limit,
and the result line last.  Exits 2 without a result when CUDA is
unavailable or the script stands outside the repo checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
MINTED = ROOT / "weights" / "minted"
TOL = 0.05                 # rtol = atol, as tests/test_tsm_conv.py
PSNR_MIN = 35.0
# K3 against its plain version in bf16: the kernel samples at u + dx, the
# plain version through the normalised grid, up to ~1e-3 px apart at
# W = 5120, so a value near a bf16 rounding step may round one ulp (2^-8
# below 1.0) the other way: atol of two ulps
WARP_TOL = 2.0**-7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


# --------------------------------------------------------------- phase 3


def check_tsm_conv(tsm, c: int, h: int, w: int, t: int = 4) -> dict:
    """K1 against tsm_conv_plain on the card at one main-path shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1000 + c)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    x = randn(t, 1, h, w, c)
    prev1, left0 = randn(1, h, w, c), randn(1, h, w, c // 8)
    wt, b = randn(3, 3, c, c, scale=0.05), randn(c, scale=0.1)

    before = tsm.launches
    got = tsm.tsm_conv(x, prev1, left0, wt, b, "relu6")
    torch.cuda.synchronize()
    assert tsm.launches == before + 1, "the wrapper did not launch the kernel"
    want = tsm.tsm_conv_plain(x, prev1, left0, wt, b, "relu6")
    err = (got.float() - want.float()).abs()
    max_err = err.max().item()
    bad = (err > TOL + TOL * want.float().abs()).sum().item()
    assert bad == 0, f"tsm_conv C={c}: {bad} values outside rtol=atol={TOL}, max |err| {max_err}"
    assert torch.isfinite(got.float()).all()

    # yardstick only (the port never calls it): one cuDNN conv over the
    # pre-built mixed input, channels_last bf16
    fold = c // 8
    hist = torch.cat([left0[None], prev1[None, ..., fold : 2 * fold], x[: t - 2, ..., fold : 2 * fold]])
    rest = torch.cat([prev1[None, ..., 2 * fold :], x[: t - 1, ..., 2 * fold :]])
    mix = torch.cat([x[..., :fold], hist, rest], -1).reshape(t, h, w, c).permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    kernel_ms = time_ms(lambda: tsm.tsm_conv(x, prev1, left0, wt, b, "relu6"))
    plain_ms = time_ms(lambda: tsm.tsm_conv_plain(x, prev1, left0, wt, b, "relu6"))
    library_ms = time_ms(lambda: F.conv2d(mix, w_oihw, b, padding=1))

    flops = 2 * 9 * c * c * h * w * t
    nbytes = sum(a.numel() * a.element_size() for a in (x, prev1, left0, wt, b, got))
    row = {
        "c": c, "h": h, "w": w, "t": t,
        "max_abs_err": max_err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "flops": flops, "bytes": nbytes,
    }
    row.update(bound(flops, nbytes))
    log(f"tsm_conv C={c} {h}x{w} T={t}: max|err| {max_err:.4g} (rtol=atol={TOL}); "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, one cuDNN conv on the "
        f"built mix {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def smooth_flow(g, h: int, w: int, max_disp: float, dev) -> torch.Tensor:
    """EGVSR-like flow as tests/test_warp_band.py makes it: uniform
    [-1, 1) on a coarse grid, bilinearly upsampled, times max_disp."""
    from sharkshark_tpu_torch.ops import resize

    coarse = torch.rand((1, max(h // 32, 2), max(w // 32, 2), 2), generator=g, device=dev) * 2 - 1
    return resize(coarse, (h, w), "bilinear") * max_disp


def check_backward_warp(wp, h: int = 2880, w: int = 5120) -> list[dict]:
    """K3 against backward_warp_plain on the card at the EGVSR path's
    shape, (1, 2880, 5120, 3) bf16 with a bf16 flow: a smooth flow within
    +-96 px, a rough uniform +-95 px flow, and the skip flag set, each in
    the NHWC and the s2d_out=4 layouts."""
    from sharkshark_tpu_torch.ops import space_to_depth

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((1, h, w, 3), generator=g, device=dev).to(torch.bfloat16)
    flows = {
        "smooth96": smooth_flow(g, h, w, 96.0, dev).to(torch.bfloat16),
        "rough95": ((torch.rand((1, h, w, 2), generator=g, device=dev) * 2 - 1) * 95).to(torch.bfloat16),
    }
    no, yes = torch.zeros(1, dtype=torch.bool, device=dev), torch.ones(1, dtype=torch.bool, device=dev)
    cases = [("smooth96", no), ("rough95", no), ("smooth96", yes)]
    # yardstick only (the port never calls it): F.grid_sample on the same
    # x and flow, as the normalised grid it takes
    iu = torch.linspace(-1.0, 1.0, w, device=dev)[None, None, :]
    iv = torch.linspace(-1.0, 1.0, h, device=dev)[None, :, None]
    x_nchw = x.permute(0, 3, 1, 2)
    rows = []
    for flow_name, skip in cases:
        flow = flows[flow_name]
        grid = torch.stack([iu + flow[..., 0].float() / ((w - 1) / 2),
                            iv + flow[..., 1].float() / ((h - 1) / 2)], dim=-1).to(x.dtype)
        for s2d in (0, 4):
            before = wp.launches
            got = wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip)
            torch.cuda.synchronize()
            assert wp.launches == before + 1, "the wrapper did not launch the kernel"
            want = wp.backward_warp_plain(x, flow, s2d_out=s2d, skip=skip)
            assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
            err = (got.float() - want.float()).abs()
            max_err = err.max().item()
            name = f"{flow_name}{'+skip' if bool(skip) else ''} {'s2d4' if s2d else 'nhwc'}"
            assert max_err <= WARP_TOL, f"backward_warp {name}: max |err| {max_err} > {WARP_TOL}"
            if bool(skip):
                ref = space_to_depth(x, s2d) if s2d else x
                assert torch.equal(got, ref), f"backward_warp {name}: the skip did not copy x exactly"
            mismatch = (err > 0).float().mean().item()

            kernel_ms = time_ms(lambda: wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip))
            plain_ms = time_ms(lambda: wp.backward_warp_plain(x, flow, s2d_out=s2d, skip=skip), reps=10)
            library_ms = time_ms(lambda: F.grid_sample(x_nchw, grid, mode="bilinear",
                                                       padding_mode="border", align_corners=True))
            # bytes the function must move: x and out once each, and the
            # flow unless the skip makes it unneeded; about 15 float32
            # operations per output value, outside the tensor cores
            used = (x, got, skip) if bool(skip) else (x, flow, got, skip)
            nbytes = sum(a.numel() * a.element_size() for a in used)
            flops = 0 if bool(skip) else 15 * got.numel()
            row = {"case": name, "shape": [1, h, w, 3], "max_abs_err": max_err,
                   "mismatch_share": mismatch, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bytes": nbytes, "flops": flops}
            row.update(bound(flops, nbytes, PEAK_F32_FLOPS))
            rows.append(row)
            log(f"backward_warp {name} (1,{h},{w},3) bf16: max|err| {max_err:.4g} (atol {WARP_TOL}), "
                f"{100 * mismatch:.4f}% of values differ; kernel {kernel_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, F.grid_sample {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return rows


# --------------------------------------------------------------- phase 4


def make_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """A smooth random scene panning 3 px right and 1 px down per frame,
    with fresh sensor noise on every frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16 + 8, w // 16 + 8, 3), dtype=np.float32)
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(coarse).permute(2, 0, 1)[None], scale_factor=16, mode="bicubic",
        align_corners=False)[0].permute(1, 2, 0).numpy()
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        view = scene[i : i + h, 3 * i : 3 * i + w]
        noisy = view * 200 + 28 + rng.normal(0, 6, view.shape)
        out[i] = np.clip(noisy, 0, 255).astype(np.uint8)
    return out


def run_main_path(service_mod, tsm, wp, card: str, jobs: int = 8, batch: int = 4) -> dict:
    from sharkshark_tpu_torch.models import bsvd
    from sharkshark_tpu_torch.runtime import EOF

    svc = service_mod.EsrganUpscalerService(
        lr_level=3, output_shape=(1440, 2560), denoising=True, denoise_rate=0.75,
        batch_size=batch, weights=str(MINTED / "srvgg-derived-x4.pth"),
        denoise_weights=str(MINTED / "bsvd-derived-32.pth"),
    )
    frames = make_frames(jobs * batch, 720, 1280, seed=7)
    got, stamps = [], []

    def on_queue(entry):
        stamps.append(time.perf_counter())
        got.append(entry)

    svc.on_queue = on_queue
    tsm.launches = wp.launches = 0
    t0 = time.perf_counter()
    svc.start()
    for i in range(jobs):
        svc.push_job(service_mod.UpscalerQueueEntry(frames=frames[i * batch : (i + 1) * batch], step=i),
                     timeout=600)
    svc.push_eof()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    wall = time.perf_counter() - t0
    svc.join(timeout=60)
    launches, warp_launches = tsm.launches, wp.launches
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"
    assert warp_launches == 0, f"the denoise path launched backward_warp {warp_launches} times"

    assert isinstance(got[-1], EOF), got[-1]
    outs = [np.asarray(e.frames) for e in got[:-1]]
    n_live = jobs * batch
    n_drained = min(n_live, bsvd.SHIFT_NUM)
    total = sum(len(o) for o in outs)
    assert total == n_live + n_drained, f"emitted {total} frames, expected {n_live + n_drained}"
    for o in outs:
        assert o.dtype == np.uint8 and o.shape[1:] == (1440, 2560, 3), (o.dtype, o.shape)
    chunks = jobs + bsvd.SHIFT_NUM // batch
    assert launches == 16 * chunks, f"tsm_conv launched {launches} times, expected {16 * chunks}"
    last = outs[jobs - 1]
    assert last.std() > 5, "the output frames are flat"
    # deliveries 0..jobs-1 are the live batches; batches >= SHIFT_NUM/batch
    # ran the warm step, and with the in-flight ring each delivery waits
    # for its own step, so their spacing is the warm step's time
    first_warm = bsvd.SHIFT_NUM // batch
    warm_s = (stamps[jobs - 1] - stamps[first_warm - 1]) / ((jobs - first_warm) * batch)
    res = {"frames": total, "launches": launches, "chunks": chunks, "wall_s": wall,
           "warm_ms_per_frame": warm_s * 1e3, "warm_fps": 1.0 / warm_s}
    log(f"main path: {total} frames of 1440x2560x3 uint8 ({n_live} live + {n_drained} drained), "
        f"tsm_conv launches {launches} = 16 x {chunks} chunks, wall {wall:.3f} s")
    log(f"warm step: {res['warm_ms_per_frame']:.3f} ms/frame, {res['warm_fps']:.3f} frames/s "
        f"(720p->1440p, denoise on, batch {batch}) on {card}")
    return res


# --------------------------------------------------------------- phase 5


def check_step_against_cpu(tsm) -> float:
    from sharkshark_tpu_torch.models import bsvd, srvgg, torch_import
    from sharkshark_tpu_torch.upscale import steps

    lr_shape, out_shape, t, chunks = (64, 96), (128, 192), 4, 6
    frames = make_frames(t * chunks, *lr_shape, seed=11)
    sd_sr = torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))
    sd_den = torch_import.load_state_dict(str(MINTED / "bsvd-derived-32.pth"))

    def run(device, dtype):
        spec = steps.UpscaleSpec(lr_shape=lr_shape, output_shape=out_shape,
                                 denoise_rate=0.75, compute_dtype=dtype)
        params = torch_import.to_tensors(
            {"sr": srvgg.from_torch(sd_sr), "denoise": bsvd.from_torch(sd_den)}, device, dtype)

        def sr_apply(p, x):
            return srvgg.apply_down_rational(p, x, 2, 1)

        state = steps.init_denoise_state(1, spec, device=device)
        outs = []
        with torch.inference_mode():
            for i in range(chunks):
                out, state = steps.upscale_batch_denoise(
                    sr_apply, params, state, torch.from_numpy(frames[i * t : (i + 1) * t]).to(device),
                    spec, warm=state["t"] >= bsvd.SHIFT_NUM)
                outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    before = tsm.launches
    card = run(torch.device("cuda"), torch.bfloat16)
    assert tsm.launches == before + 16 * chunks, "the card's step did not run the kernel"
    cpu = run(torch.device("cpu"), torch.float32)
    value = psnr(card, cpu)
    log(f"whole step, card bf16 vs CPU float32 at {lr_shape} -> {out_shape}, {chunks} chunks of "
        f"{t} (4 cold, {chunks - 4} warm): PSNR {value:.3f} dB (min {PSNR_MIN})")
    assert value >= PSNR_MIN, f"PSNR {value:.3f} dB below {PSNR_MIN}"
    return value


# --------------------------------------------------------------- phase 6


def run_egvsr_path(service_mod, tsm, wp, card: str, chunked: bool = False, jobs: int = 6,
                   batch: int = 4) -> tuple[dict, np.ndarray]:
    from sharkshark_tpu_torch.runtime import EOF

    route = "chunked" if chunked else "per-frame"
    svc = service_mod.EgvsrUpscalerService(
        lr_level=3, output_shape=(1440, 2560), weights=str(MINTED / "egvsr-derived-x4.pth"),
        chunked=chunked)
    svc.proc_init()
    assert (svc.cfg.nb, svc.cfg.degradation) == (10, "BI"), svc.cfg
    frames = make_frames(jobs * batch, 720, 1280, seed=13)
    got, stamps = [], []

    def on_queue(entry):
        stamps.append(time.perf_counter())
        got.append(entry)

    svc.on_queue = on_queue
    tsm.launches = wp.launches = 0
    t0 = time.perf_counter()
    svc.start()
    for i in range(jobs):
        svc.push_job(service_mod.UpscalerQueueEntry(frames=frames[i * batch : (i + 1) * batch], step=i),
                     timeout=600)
    svc.push_eof()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    wall = time.perf_counter() - t0
    svc.join(timeout=60)
    launches, tsm_launches = wp.launches, tsm.launches
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"

    assert isinstance(got[-1], EOF), got[-1]
    outs = [np.asarray(e.frames) for e in got[:-1]]
    total = sum(len(o) for o in outs)
    n = jobs * batch
    assert total == n, f"emitted {total} frames, expected {n}"
    for o in outs:
        assert o.dtype == np.uint8 and o.shape[1:] == (1440, 2560, 3), (o.dtype, o.shape)
        assert min(f.std() for f in o) > 5, "an output frame is flat"
    assert launches == n, f"backward_warp launched {launches} times, expected {n} (one per frame)"
    assert tsm_launches == 0, f"the EGVSR path launched tsm_conv {tsm_launches} times"
    # with the in-flight ring each delivery waits for its own micro-batch,
    # so from the second delivery on their spacing is the step's time
    per_frame_s = (stamps[jobs - 1] - stamps[0]) / ((jobs - 1) * batch)
    res = {"route": route, "frames": total, "launches": launches, "wall_s": wall,
           "ms_per_frame": per_frame_s * 1e3, "fps": 1.0 / per_frame_s}
    log(f"EGVSR path ({route}): {total} frames of 1440x2560x3 uint8 from 720x1280 (HR 2880x5120), "
        f"backward_warp launches {launches}, wall {wall:.3f} s")
    log(f"EGVSR step ({route}): {res['ms_per_frame']:.3f} ms/frame, {res['fps']:.3f} frames/s "
        f"(batch {batch}, cut_threshold 0.12) on {card}")
    return res, np.concatenate(outs)


# --------------------------------------------------------------- phase 7


def check_egvsr_step_against_cpu(wp) -> float:
    from sharkshark_tpu_torch.models import egvsr, torch_import
    from sharkshark_tpu_torch.upscale import steps

    lr_shape, out_shape, n = (64, 128), (128, 256), 8
    frames = make_frames(n, *lr_shape, seed=17)
    sd = torch_import.load_state_dict(str(MINTED / "egvsr-derived-x4.pth"))
    cfg = egvsr.config_from_torch(sd)

    def run(device, dtype):
        spec = steps.UpscaleSpec(lr_shape=lr_shape, output_shape=out_shape, compute_dtype=dtype)
        params = torch_import.to_tensors(egvsr.from_torch(sd, cfg), device, dtype)
        state = egvsr.init_recurrent_state(1, *lr_shape, cfg, dtype, device)
        outs = []
        with torch.inference_mode():
            for i in range(n):
                out, state = steps.egvsr_upscale_step(
                    params, state, torch.from_numpy(frames[i : i + 1]).to(device), spec,
                    cut_threshold=0.12, cfg=cfg)
                outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    before = wp.launches
    card = run(torch.device("cuda"), torch.bfloat16)
    assert wp.launches == before + n, "the card's step did not run the kernel"
    cpu = run(torch.device("cpu"), torch.float32)
    per_frame = [psnr(card[i], cpu[i]) for i in range(n)]
    value = psnr(card, cpu)
    log(f"EGVSR step, card bf16 vs CPU float32 at {lr_shape} -> {out_shape}, {n} frames of the "
        f"recurrence: PSNR {value:.3f} dB (min {PSNR_MIN}); per frame "
        + " ".join(f"{v:.2f}" for v in per_frame))
    assert value >= PSNR_MIN, f"PSNR {value:.3f} dB below {PSNR_MIN}"
    return value


# --------------------------------------------------------------- phase 8


def run_cli(tsm, wp, card: str, n: int = 24) -> list[dict]:
    """The port's CLI, through the pipeline and the stream layer, with
    tests/fake_ffmpeg.py standing in for ffmpeg: 24 frames of 720p60 in
    (the lr_shape, so no host resize), a raw 1440x2560 rgb24 file out."""
    from sharkshark_tpu_torch.main import upscaler

    frame_bytes = 1440 * 2560 * 3
    results = []
    build = ROOT / "sharkshark_tpu_torch" / "build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        fake = Path(tmp) / "ffmpeg"
        fake.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{ROOT / "tests" / "fake_ffmpeg.py"}" "$@"\n')
        fake.chmod(0o755)
        src = Path(tmp) / "source.mp4"
        src.write_bytes(b"")
        os.environ["SHARKSHARK_FFMPEG"] = str(fake)
        os.environ["FAKE_FFMPEG_FRAMES"] = str(n)
        runs = [
            ("egvsr", ["--model", "egvsr", "--weights", str(MINTED / "egvsr-derived-x4.pth")],
             n, wp, n),
            ("realesrgan+denoise", ["--weights", str(MINTED / "srvgg-derived-x4.pth"),
                                    "--denoise-weights", str(MINTED / "bsvd-derived-32.pth")],
             n + min(n, 16), tsm, 16 * (n // 4 + 16 // 4)),
        ]
        for name, extra, frames_out, counter, want_launches in runs:
            out = Path(tmp) / f"{name}.raw"
            tsm.launches = wp.launches = 0
            t0 = time.perf_counter()
            upscaler.main(["--url", str(src), "--quality", "720p60", "--fps", "24",
                           "--no-frame-skips", "--no-overlay", "--output-file", str(out), *extra])
            wall = time.perf_counter() - t0
            launches = counter.launches
            size = out.stat().st_size
            assert size == frames_out * frame_bytes, (
                f"CLI {name}: wrote {size} bytes, expected {frames_out} x {frame_bytes}")
            assert launches == want_launches, f"CLI {name}: {launches} kernel launches, expected {want_launches}"
            results.append({"run": name, "frames_out": frames_out, "bytes": size,
                            "launches": launches, "wall_s": wall})
            log(f"CLI {name}: {frames_out} frames of 1440x2560x3 ({size} bytes), "
                f"{launches} kernel launches, wall {wall:.3f} s on {card}")
            out.unlink()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "sharkshark_tpu_torch" / "csrc").is_dir() or not MINTED.is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sharkshark_tpu_torch.ops import _build
    from sharkshark_tpu_torch.ops import tsm_conv as tsm
    from sharkshark_tpu_torch.ops import warp as wp
    from sharkshark_tpu_torch.upscale import service as service_mod

    # 1. card and settings
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    sources = ["tsm_conv", "backward_warp"]
    logs = _build.build(sources, verbose=True)
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions
    rows = [check_tsm_conv(tsm, 64, 360, 640), check_tsm_conv(tsm, 128, 180, 320)]
    warp_rows = check_backward_warp(wp)

    # 4. the denoise path
    main_res = run_main_path(service_mod, tsm, wp, card)

    # 5. whole step, card against CPU
    step_psnr = check_step_against_cpu(tsm)

    # 6. the EGVSR path, per frame (the default) and chunked
    egvsr_res, egvsr_out = run_egvsr_path(service_mod, tsm, wp, card)
    chunk_res, chunk_out = run_egvsr_path(service_mod, tsm, wp, card, chunked=True)
    chunk_res["psnr_vs_per_frame_db"] = psnr(chunk_out, egvsr_out)
    log(f"EGVSR chunked vs per-frame route on the card: PSNR {chunk_res['psnr_vs_per_frame_db']:.3f} dB "
        f"(min {PSNR_MIN})")
    assert chunk_res["psnr_vs_per_frame_db"] >= PSNR_MIN, "the chunked route disagrees with the per-frame one"

    # 7. EGVSR step, card against CPU
    egvsr_psnr = check_egvsr_step_against_cpu(wp)

    # 8. the CLI through the pipeline
    cli_res = run_cli(tsm, wp, card)

    # the kernels line: per launch, averaged over the main path's mix
    # (one C=64 and one C=128 launch per temporal-shift conv pair of a
    # chunk's DenBlock), with the bound of that same work
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    mix_bound = bound(sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows))
    kernel = {
        "name": "tsm_conv", "route": "cuda",
        "source": "sharkshark_tpu_torch/csrc/tsm_conv.cu",
        "replaces": "sharkshark_tpu/ops/pallas/tsm_conv.py:227",
        "launches": main_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("kernel_ms"), "kernel_ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mix_bound["bound_ms"] / len(rows), "bound_by": mix_bound["bound_by"],
        "library_ms": mean("library_ms"),
        "shapes": rows,
    }
    # K3 at the EGVSR path's own case: a smooth flow, s2d_out=4, no cut
    main_case = next(r for r in warp_rows if r["case"] == "smooth96 s2d4")
    warp_kernel = {
        "name": "backward_warp", "route": "cuda",
        "source": "sharkshark_tpu_torch/csrc/backward_warp.cu",
        "replaces": "sharkshark_tpu/ops/pallas/warp_band.py:262",
        "launches": egvsr_res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in warp_rows),
        "ms": main_case["kernel_ms"], "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
        "cases": warp_rows,
    }
    log(json.dumps({"main_path": main_res, "step_psnr_db": step_psnr, "egvsr_path": egvsr_res,
                    "egvsr_chunked_path": chunk_res, "egvsr_step_psnr_db": egvsr_psnr, "cli": cli_res, "card": card}))
    log(json.dumps({"kernels": [kernel, warp_kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
