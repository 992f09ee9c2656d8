#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sharkshark_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing is caught):
  1. card and settings: name and power limit (nvidia-smi), TF32 off;
  2. build every CUDA kernel of the path from the sources, in parallel;
  3. each kernel against its plain PyTorch version on the card at the
     main path's shapes, with timings (CUDA events, median of 30) beside
     the bound derived from the H100 SXM data sheet;
  4. the main path at full width: the port's EsrganUpscalerService,
     720p -> 1440p with BSVD-32 denoise and SRVGG general-x4v3 (the
     repo's minted weights), driven as the live pipeline drives it, with
     the kernel launch counts read around that run;
  5. the whole denoise step on the card (bf16) against the port on the
     CPU (float32) at a small size, by PSNR;
then one JSON line of kernel numbers, the card's name and power limit,
and the result line last.  Exits 2 without a result when CUDA is
unavailable or the script stands outside the repo checkout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
MINTED = ROOT / "weights" / "minted"
TOL = 0.05                 # rtol = atol, as tests/test_tsm_conv.py
PSNR_MIN = 35.0


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


def bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def run_main_path(service_mod, tsm, card: str, jobs: int = 8, batch: int = 4) -> dict:
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
    tsm.launches = 0
    t0 = time.perf_counter()
    svc.start()
    for i in range(jobs):
        svc.push_job(service_mod.UpscalerQueueEntry(frames=frames[i * batch : (i + 1) * batch], step=i),
                     timeout=600)
    svc.push_eof()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    wall = time.perf_counter() - t0
    svc.join(timeout=60)
    launches = tsm.launches
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"

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
    from sharkshark_tpu_torch.upscale import service as service_mod

    # 1. card and settings
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(["tsm_conv"], verbose=True)
    log(f"built tsm_conv in {time.perf_counter() - t0:.2f} s")
    for line in logs["tsm_conv"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel against its plain version
    rows = [check_tsm_conv(tsm, 64, 360, 640), check_tsm_conv(tsm, 128, 180, 320)]

    # 4. the main path
    main_res = run_main_path(service_mod, tsm, card)

    # 5. whole step, card against CPU
    step_psnr = check_step_against_cpu(tsm)

    # 6. the kernels line: per launch, averaged over the main path's mix
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
    log(json.dumps({"main_path": main_res, "step_psnr_db": step_psnr, "card": card}))
    log(json.dumps({"kernels": [kernel]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
