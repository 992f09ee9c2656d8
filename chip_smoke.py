#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sharkshark_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing is caught):
  1. card and settings: name and power limit (nvidia-smi), TF32 off, the
     service's default routes (tsm_pair, conv_stack);
  2. build every CUDA kernel of the paths from the sources (three), in
     parallel;
  3. each kernel against its plain PyTorch version on the card at the
     main paths' shapes, with timings (CUDA events around each call,
     median of 30) beside the bound derived from the H100 SXM data sheet
     and a PyTorch call of the same function as a yardstick (timing and
     bound from tools/bench_tsm_conv.py): K1 and K2 (tsm_conv,
     tsm_conv_pair, two chained K1 launches a call) at the warm chunk's
     shapes (K1 also with its share of the bound and its persistent
     grid, blocks against tiles; K2 beside two tsm_conv calls and two
     cuDNN convs), K3 (backward_warp, through
     tools/bench_backward_warp.py) at EGVSR's, per call and back to back
     (its device time), K4 (fused_conv_stack, through
     tools/bench_conv_stack.py) at SRVGG's body for L = 1, 2, 4 (L
     launches of the one-layer kernel), with its share of the bound and
     its grid;
  4. the denoise path at full width: first the warm step's ms/frame
     under each route (K1 or K2; the body layer by layer or through K4
     at L = 1, 2, 4; the skip rings updated in place, as the service
     does, and, once, copied), then the port's EsrganUpscalerService, 720p ->
     1440p with BSVD-32 denoise and SRVGG general-x4v3 (the repo's
     minted weights), driven as the live pipeline drives it, with the
     kernel launch counts read around each run: with the service's
     defaults (the main path), with both routes on, and with K1 alone and
     the layer-by-layer body, held against each other by PSNR;
  5. the whole denoise step with both routes on, on the card (bf16)
     against the port on the CPU (float32) at a small size, by PSNR;
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
     by tests/fake_ffmpeg.py, with the output file's size checked; then
     the paced end-to-end bench (tools/bench_e2e.py) once, default
     denoise at 24 frames/s for 10 s, its frame accounting checked;
  9. K4's other paths: the SR-only service (denoising off) at 720p ->
     1440p; the image server's settings with 8 single-frame 256x256
     requests coalesced into fewer dispatches, each held against its own
     uncoalesced run; tile_upscale over a 720p image in 15 tiles;
then one JSON line of kernel numbers, the card's name and power limit,
and the result line last.  Exits 2 without a result when CUDA is
unavailable or the script stands outside the repo checkout.
"""

from __future__ import annotations

import inspect
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
MINTED = ROOT / "weights" / "minted"
PSNR_MIN = 35.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


# --------------------------------------------------------------- phase 3


def check_tsm_conv(tsm, bench, c: int, h: int, w: int) -> dict:
    """K1 against tsm_conv_plain on the card at one main-path shape, then
    timed beside its plain version, one cuDNN conv on the built mix and
    its bound (tools/bench_tsm_conv.py's measurement), with its
    persistent grid."""
    row = bench.measure(c, h, w)
    row["tiles"], row["blocks"] = tsm.kernel_schedule(row["t"], 1, h, w, c)
    log(f"tsm_conv C={c} {h}x{w} T={row['t']}: max|err| {row['max_abs_err']:.4g} (rtol=atol={bench.TOL}); "
        f"kernel {row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, one cuDNN conv on the "
        f"built mix {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{100 * row['bound_share']:.1f}% of the bound; {row['blocks']} persistent blocks for "
        f"{row['tiles']} tiles")
    return row


def nbytes_of(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors if a is not None)


def check_tsm_conv_pair(tsm, bench, c: int, h: int, w: int, t: int = 4) -> dict:
    """K2 against tsm_conv_pair_plain on the card at one warm-chunk shape:
    y2 and the carry y1_last2 at rtol = atol = 0.05, with two K1 launches
    a call; timed beside two tsm_conv calls, its plain version, two cuDNN
    convs and its bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2000 + c)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    x = randn(t, 1, h, w, c)
    carries = [randn(1, h, w, c), randn(1, h, w, c // 8), randn(1, h, w, c), randn(1, h, w, c // 8)]
    w1, b1, w2, b2 = randn(3, 3, c, c, scale=0.05), randn(c, scale=0.1), randn(3, 3, c, c, scale=0.05), randn(c, scale=0.1)
    args = (x, *carries, w1, b1, w2, b2, "relu6")

    before, k1_before = tsm.pair_launches, tsm.launches
    got_y2, got_carry = tsm.tsm_conv_pair(*args)
    torch.cuda.synchronize()
    assert (tsm.pair_launches, tsm.launches) == (before + 1, k1_before + 2), (
        "the wrapper did not make two K1 launches")
    want_y2, want_carry = tsm.tsm_conv_pair_plain(*args)
    max_err = 0.0
    for name, got, want in (("y2", got_y2, want_y2), ("y1_last2", got_carry, want_carry)):
        assert got.shape == want.shape and got.dtype == torch.bfloat16, (name, got.shape, want.shape)
        err = (got.float() - want.float()).abs()
        bad = (err > bench.TOL + bench.TOL * want.float().abs()).sum().item()
        max_err = max(max_err, err.max().item())
        assert bad == 0, f"tsm_conv_pair C={c} {name}: {bad} values outside rtol=atol={bench.TOL}"
        assert torch.isfinite(got.float()).all()

    def two_k1():
        y1 = tsm.tsm_conv(x, carries[0], carries[1], w1, b1, "relu6")
        return tsm.tsm_conv(y1, carries[2], carries[3], w2, b2, "relu6")

    # yardstick only (the port never calls it): two cuDNN convs over the
    # pre-built mixed inputs, the second on the plain version's y1
    y1_plain = tsm.tsm_conv_plain(x, carries[0], carries[1], w1, b1, "relu6")
    mix1, mix2 = bench.built_mix(x, carries[0], carries[1]), bench.built_mix(y1_plain, carries[2], carries[3])
    w1_oihw, w2_oihw = bench.oihw(w1), bench.oihw(w2)
    kernel_ms = bench.time_ms(lambda: tsm.tsm_conv_pair(*args))
    two_k1_ms = bench.time_ms(two_k1)
    plain_ms = bench.time_ms(lambda: tsm.tsm_conv_pair_plain(*args))
    library_ms = bench.time_ms(lambda: (F.conv2d(mix1, w1_oihw, b1, padding=1), F.conv2d(mix2, w2_oihw, b2, padding=1)))

    flops = 2 * 2 * 9 * c * c * h * w * t
    nbytes = nbytes_of(x, *carries, w1, b1, w2, b2, got_y2, got_carry)
    row = {
        "c": c, "h": h, "w": w, "t": t, "max_abs_err": max_err, "kernel_ms": kernel_ms,
        "two_k1_ms": two_k1_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "flops": flops, "bytes": nbytes,
    }
    row.update(bench.bound(flops, nbytes))
    log(f"tsm_conv_pair C={c} {h}x{w} T={t}: max|err| {max_err:.4g} (rtol=atol={bench.TOL}); "
        f"kernel {kernel_ms:.4f} ms, two tsm_conv calls {two_k1_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"two cuDNN convs on the built mixes {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def check_conv_stack(cs, bench_cs, n_layers: int, with_bias: bool) -> dict:
    """K4 against fused_conv_stack_plain on the card at the SRVGG body's
    shape, within 0.02 x max(|ref|max, 1) as the Pallas kernel's test,
    then timed beside its plain version, the layer-by-layer route and its
    bound (tools/bench_conv_stack.py's measurement), with its grid."""
    row = bench_cs.measure(n_layers, with_bias)
    assert row["launches_per_call"] == n_layers, f"K4 at L={n_layers}: {row['launches_per_call']} launches a call"
    n, h, w, _ = row["shape"]
    row["tiles"], row["blocks"] = cs.kernel_schedule(n, h, w, n_layers)
    log(f"fused_conv_stack L={n_layers} {'bias' if with_bias else 'no bias'} ({n},{h},{w},64) bf16: "
        f"max|err| {row['max_abs_err']:.4g} (limit {bench_cs.TOL * max(row['ref_max'], 1.0):.4g}); "
        f"kernel {row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, conv2d+bias+prelu route "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{100 * row['bound_share']:.1f}% of the bound; {n_layers} launches of {row['blocks']} blocks for "
        f"{row['tiles']} tiles")
    return row


def check_backward_warp(bench_warp) -> list[dict]:
    """K3 against backward_warp_plain on the card at the EGVSR path's
    shape, (1, 2880, 5120, 3) bf16 with a bf16 flow: a smooth flow within
    +-96 px, a rough uniform +-95 px flow, and the skip flag set, each in
    the NHWC and the s2d_out=4 layouts; timed per call and back to back
    beside F.grid_sample and the bound (tools/bench_backward_warp.py's
    measurement)."""
    rows = bench_warp.measure()
    for row in rows:
        log(f"backward_warp {row['case']} {tuple(row['shape'])} bf16: max|err| {row['max_abs_err']:.4g} "
            f"(atol {bench_warp.TOL}), {100 * row['mismatch_share']:.4f}% of values differ; kernel "
            f"{row['kernel_ms']:.4f} ms a call, {row['device_ms']:.4f} ms back to back; plain "
            f"{row['plain_ms']:.4f} ms; F.grid_sample {row['library_ms']:.4f} ms a call, "
            f"{row['library_device_ms']:.4f} ms back to back; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB), {100 * row['bound_share']:.1f}% of it "
            f"back to back")
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


class Counters:
    """The launch counts of every kernel wrapper, set to 0 and read as one."""

    def __init__(self, tsm, wp, cs):
        self.tsm, self.wp, self.cs = tsm, wp, cs

    def reset(self) -> None:
        self.tsm.launches = self.tsm.pair_launches = self.wp.launches = self.cs.launches = 0

    def read(self) -> dict:
        return {"tsm_conv": self.tsm.launches, "tsm_conv_pair": self.tsm.pair_launches,
                "backward_warp": self.wp.launches, "fused_conv_stack": self.cs.launches}


def denoise_launches(cold: int, warm: int, flush: int, tsm_pair: bool, conv_stack: int) -> dict:
    """Kernel launches that a run of the denoise path implies: 16 K1 per
    chunk, with tsm_pair too (a warm chunk's 8 K2 calls make 2 each), and
    32 K4 per SRVGG apply (one per chunk), one a body layer, with any
    conv_stack = L > 0."""
    chunks = cold + warm + flush
    return {"tsm_conv": 16 * chunks,
            "tsm_conv_pair": 8 * warm if tsm_pair else 0, "backward_warp": 0,
            "fused_conv_stack": chunks * 32 if conv_stack else 0}


def run_main_path(service_mod, counters, card: str, tsm_pair: bool, conv_stack: int,
                  jobs: int = 8, batch: int = 4) -> tuple[dict, np.ndarray]:
    from sharkshark_tpu_torch.models import bsvd
    from sharkshark_tpu_torch.runtime import EOF

    route = f"tsm_pair={tsm_pair}, conv_stack={conv_stack}"
    svc = service_mod.EsrganUpscalerService(
        lr_level=3, output_shape=(1440, 2560), denoising=True, denoise_rate=0.75,
        batch_size=batch, weights=str(MINTED / "srvgg-derived-x4.pth"),
        denoise_weights=str(MINTED / "bsvd-derived-32.pth"), tsm_pair=tsm_pair, conv_stack=conv_stack,
    )
    frames = make_frames(jobs * batch, 720, 1280, seed=7)
    got, stamps = [], []

    def on_queue(entry):
        stamps.append(time.perf_counter())
        got.append(entry)

    svc.on_queue = on_queue
    counters.reset()
    t0 = time.perf_counter()
    svc.start()
    for i in range(jobs):
        svc.push_job(service_mod.UpscalerQueueEntry(frames=frames[i * batch : (i + 1) * batch], step=i),
                     timeout=600)
    svc.push_eof()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    wall = time.perf_counter() - t0
    svc.join(timeout=60)
    launches = counters.read()
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"

    assert isinstance(got[-1], EOF), got[-1]
    outs = [np.asarray(e.frames) for e in got[:-1]]
    n_live = jobs * batch
    n_drained = min(n_live, bsvd.SHIFT_NUM)
    total = sum(len(o) for o in outs)
    assert total == n_live + n_drained, f"emitted {total} frames, expected {n_live + n_drained}"
    for o in outs:
        assert o.dtype == np.uint8 and o.shape[1:] == (1440, 2560, 3), (o.dtype, o.shape)
    first_warm = bsvd.SHIFT_NUM // batch
    want = denoise_launches(first_warm, jobs - first_warm, bsvd.SHIFT_NUM // batch, tsm_pair, conv_stack)
    assert launches == want, f"denoise path ({route}): launches {launches}, expected {want}"
    last = outs[jobs - 1]
    assert last.std() > 5, "the output frames are flat"
    # deliveries 0..jobs-1 are the live batches; batches >= SHIFT_NUM/batch
    # ran the warm step, and with the in-flight ring each delivery waits
    # for its own step, so their spacing is the warm step's time
    warm_s = (stamps[jobs - 1] - stamps[first_warm - 1]) / ((jobs - first_warm) * batch)
    res = {"route": route, "frames": total, "launches": launches, "chunks": jobs + bsvd.SHIFT_NUM // batch,
           "wall_s": wall, "warm_ms_per_frame": warm_s * 1e3, "warm_fps": 1.0 / warm_s}
    log(f"denoise path ({route}): {total} frames of 1440x2560x3 uint8 ({n_live} live + {n_drained} "
        f"drained), launches {launches}, wall {wall:.3f} s")
    log(f"warm step ({route}): {res['warm_ms_per_frame']:.3f} ms/frame, {res['warm_fps']:.3f} frames/s "
        f"(720p->1440p, denoise on, batch {batch}) on {card}")
    return res, np.concatenate(outs)


def time_denoise_routes(routes: list[dict], card: str, batch: int = 4, iters: int = 6) -> list[dict]:
    """The warm denoise step (steps.upscale_batch_denoise at 720p -> 1440p,
    T=4, minted weights) in ms/frame under each route (tsm_pair,
    conv_stack, and inplace, the service's in-place skip rings, unless a
    route sets it False), host time around `iters` synchronised warm
    steps, in two passes (forward, then reversed) and the median of each
    route's two."""
    from sharkshark_tpu_torch.models import bsvd, srvgg, torch_import
    from sharkshark_tpu_torch.upscale import steps

    dev, dtype = torch.device("cuda"), torch.bfloat16
    spec = steps.UpscaleSpec(lr_shape=(720, 1280), output_shape=(1440, 2560), denoise_rate=0.75,
                             compute_dtype=dtype)
    params = torch_import.to_tensors({
        "sr": srvgg.from_torch(torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))),
        "denoise": bsvd.from_torch(torch_import.load_state_dict(str(MINTED / "bsvd-derived-32.pth"))),
    }, dev, dtype)
    frames = torch.from_numpy(make_frames(batch, 720, 1280, seed=19)).to(dev)
    times: dict[int, list[float]] = {i: [] for i in range(len(routes))}
    order = list(range(len(routes)))
    with torch.inference_mode():
        for i in order + order[::-1]:
            r = routes[i]

            def sr_apply(p, x, L=r["conv_stack"]):
                return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=L)

            kw = {"tsm_pair": r["tsm_pair"], "inplace": r.get("inplace", True)}
            state = steps.init_denoise_state(1, spec, device=dev)
            while state["t"] <= bsvd.SHIFT_NUM:  # cold chunks, then one warm
                _, state = steps.upscale_batch_denoise(sr_apply, params, state, frames, spec,
                                                       warm=state["t"] >= bsvd.SHIFT_NUM, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                _, state = steps.upscale_batch_denoise(sr_apply, params, state, frames, spec, warm=True, **kw)
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) / (iters * batch) * 1e3)
    rows = []
    for i, r in enumerate(routes):
        rows.append({**r, "warm_ms_per_frame": statistics.median(times[i]), "passes": times[i]})
        log(f"warm denoise step, {', '.join(f'{k}={v}' for k, v in r.items())}: "
            f"{rows[-1]['warm_ms_per_frame']:.3f} ms/frame (passes "
            + ", ".join(f"{v:.3f}" for v in times[i]) + f") on {card}")
    return rows


# --------------------------------------------------------------- phase 5


def check_step_against_cpu(counters, tsm_pair: bool, conv_stack: int) -> float:
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
            return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=conv_stack)

        state = steps.init_denoise_state(1, spec, device=device)
        outs = []
        with torch.inference_mode():
            for i in range(chunks):
                out, state = steps.upscale_batch_denoise(
                    sr_apply, params, state, torch.from_numpy(frames[i * t : (i + 1) * t]).to(device),
                    spec, warm=state["t"] >= bsvd.SHIFT_NUM, tsm_pair=tsm_pair)
                outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    counters.reset()
    card = run(torch.device("cuda"), torch.bfloat16)
    want = denoise_launches(4, chunks - 4, 0, tsm_pair, conv_stack)
    assert counters.read() == want, f"the card's step launched {counters.read()}, expected {want}"
    cpu = run(torch.device("cpu"), torch.float32)
    value = psnr(card, cpu)
    log(f"whole step (tsm_pair={tsm_pair}, conv_stack={conv_stack}), card bf16 vs CPU float32 at "
        f"{lr_shape} -> {out_shape}, {chunks} chunks of {t} (4 cold, {chunks - 4} warm): "
        f"PSNR {value:.3f} dB (min {PSNR_MIN})")
    assert value >= PSNR_MIN, f"PSNR {value:.3f} dB below {PSNR_MIN}"
    return value


# --------------------------------------------------------------- phase 6


def run_egvsr_path(service_mod, counters, card: str, chunked: bool = False, jobs: int = 6,
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
    counters.reset()
    t0 = time.perf_counter()
    svc.start()
    for i in range(jobs):
        svc.push_job(service_mod.UpscalerQueueEntry(frames=frames[i * batch : (i + 1) * batch], step=i),
                     timeout=600)
    svc.push_eof()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    wall = time.perf_counter() - t0
    svc.join(timeout=60)
    counts = counters.read()
    launches = counts.pop("backward_warp")
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
    assert not any(counts.values()), f"the EGVSR path launched other kernels: {counts}"
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


def run_cli(counters, card: str, defaults: dict, n: int = 24) -> list[dict]:
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
        egvsr_launches = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": n, "fused_conv_stack": 0}
        runs = [
            ("egvsr", ["--model", "egvsr", "--weights", str(MINTED / "egvsr-derived-x4.pth")],
             n, egvsr_launches),
            # micro-batches of 4: 4 cold chunks, then warm ones, then 4 flush chunks
            ("realesrgan+denoise", ["--weights", str(MINTED / "srvgg-derived-x4.pth"),
                                    "--denoise-weights", str(MINTED / "bsvd-derived-32.pth")],
             n + min(n, 16), denoise_launches(4, n // 4 - 4, 4, **defaults)),
        ]
        for name, extra, frames_out, want_launches in runs:
            out = Path(tmp) / f"{name}.raw"
            counters.reset()
            t0 = time.perf_counter()
            upscaler.main(["--url", str(src), "--quality", "720p60", "--fps", "24",
                           "--no-frame-skips", "--no-overlay", "--output-file", str(out), *extra])
            wall = time.perf_counter() - t0
            launches = counters.read()
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


def run_bench_e2e(card: str, seconds: float = 10.0) -> list[dict]:
    """The paced end-to-end bench (tools/bench_e2e.py) once: the default
    denoise pipeline fed 24 frames/s for `seconds`.  Only its frame
    accounting is held, not a rate: every source frame is delivered live
    or counted dropped, and the EOF drain delivers min(N, 16) more."""
    from sharkshark_tpu_torch.models import bsvd
    from sharkshark_tpu_torch.tools import bench_e2e

    rows = bench_e2e.run(["--seconds", str(seconds), "--fps", "24"])
    by = {r["metric"]: r for r in rows}
    acct = by["drop_pct"]
    assert acct["frames_in"] == int(seconds * 24), acct
    assert acct["frames_live"] + acct["frames_dropped"] == acct["frames_in"], f"frames lost: {acct}"
    assert acct["frames_drained"] == min(acct["frames_live"], bsvd.SHIFT_NUM), acct
    assert all(r["card"] == card for r in rows), [r["card"] for r in rows]
    log(json.dumps({"bench_e2e": rows}))
    return rows


# --------------------------------------------------------------- phase 9


def drive(svc, entry_cls, jobs: list, queued: bool = False) -> tuple[list, list, list]:
    """Push `jobs` through a started service (or, with `queued`, push them
    all before it starts, as concurrent requests arrive); returns the
    delivered entries, their arrival times and the frames per dispatch."""
    from sharkshark_tpu_torch.runtime import EOF

    dispatched, got, stamps = [], [], []
    orig = svc.upscale_dispatch

    def counting(frames):
        dispatched.append(len(frames))
        return orig(frames)

    def on_queue(entry):
        stamps.append(time.perf_counter())
        got.append(entry)

    svc.upscale_dispatch, svc.on_queue = counting, on_queue
    if not queued:
        svc.start()
    for i, frames in enumerate(jobs):
        svc.push_job(entry_cls(frames=frames, step=i), timeout=600)
    svc.push_eof()
    if queued:
        svc.start()
    assert svc.wait_eof(timeout=900), "the service did not reach EOF"
    svc.join(timeout=60)
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"
    assert isinstance(got[-1], EOF), got[-1]
    return got[:-1], stamps[:-1], dispatched


def run_sr_path(service_mod, counters, card: str, conv_stack: int, jobs: int = 8, batch: int = 4) -> dict:
    """The SR-only service (--no-denoise: steps.upscale_multi with the
    local color match) at 720p -> 1440p, SRVGG's body through K4."""
    svc = service_mod.EsrganUpscalerService(
        lr_level=3, output_shape=(1440, 2560), denoising=False, batch_size=batch,
        weights=str(MINTED / "srvgg-derived-x4.pth"), conv_stack=conv_stack)
    svc.proc_init()
    frames = make_frames(jobs * batch, 720, 1280, seed=23)
    counters.reset()
    t0 = time.perf_counter()
    got, stamps, _ = drive(svc, service_mod.UpscalerQueueEntry,
                           [frames[i * batch : (i + 1) * batch] for i in range(jobs)])
    wall = time.perf_counter() - t0
    launches = counters.read()
    outs = [np.asarray(e.frames) for e in got]
    assert sum(len(o) for o in outs) == jobs * batch, [len(o) for o in outs]
    for o in outs:
        assert o.dtype == np.uint8 and o.shape[1:] == (1440, 2560, 3), (o.dtype, o.shape)
        assert min(f.std() for f in o) > 5, "an output frame is flat"
    want = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": 0,
            "fused_conv_stack": jobs * 32 if conv_stack else 0}
    assert launches == want, f"SR-only path: launches {launches}, expected {want}"
    per_frame_s = (stamps[-1] - stamps[0]) / ((jobs - 1) * batch)
    res = {"frames": jobs * batch, "conv_stack": conv_stack, "launches": launches, "wall_s": wall,
           "ms_per_frame": per_frame_s * 1e3, "fps": 1.0 / per_frame_s}
    log(f"SR-only path (conv_stack={conv_stack}): {jobs * batch} frames of 1440x2560x3 uint8, "
        f"launches {launches}, wall {wall:.3f} s; {res['ms_per_frame']:.3f} ms/frame, "
        f"{res['fps']:.3f} frames/s (batch {batch}) on {card}")
    return res


def run_coalesced_requests(service_mod, counters, card: str, conv_stack: int, n: int = 8) -> dict:
    """The image server's service settings (one frame a request, no LR/HR
    resize, output at 4x, coalesce_max=8): n single-frame 256x256
    requests pushed at once, against the same requests one at a time."""
    kw = dict(lr_level=0, denoising=False, batch_size=1, lr_hr_resize=False, output_shape=None,
              weights=str(MINTED / "srvgg-derived-x4.pth"), conv_stack=conv_stack)
    frames = make_frames(n, 256, 256, seed=29)
    jobs = [frames[i : i + 1] for i in range(n)]
    results = {}
    for name, coalesce in (("coalesced", n), ("one by one", 1)):
        svc = service_mod.EsrganUpscalerService(coalesce_max=coalesce, **kw)
        svc.proc_init()
        svc.upscale(np.concatenate(jobs[:coalesce]))  # warm-up at the dispatch size
        counters.reset()
        t0 = time.perf_counter()
        got, _, dispatched = drive(svc, service_mod.UpscalerQueueEntry, jobs, queued=True)
        wall = time.perf_counter() - t0
        assert [e.step for e in got] == list(range(n)), [e.step for e in got]
        outs = [np.asarray(e.frames) for e in got]
        for o in outs:
            assert o.dtype == np.uint8 and o.shape == (1, 1024, 1024, 3), (o.dtype, o.shape)
        results[name] = {"dispatches": dispatched, "launches": counters.read()["fused_conv_stack"],
                         "wall_s": wall, "outs": outs}
    co, alone = results["coalesced"], results["one by one"]
    assert len(co["dispatches"]) < n, f"the service did not coalesce: dispatches {co['dispatches']}"
    assert len(alone["dispatches"]) == n, alone["dispatches"]
    worst = min(psnr(a, b) for a, b in zip(co["outs"], alone["outs"]))
    assert worst >= 45.0, f"a coalesced request's frame is {worst:.3f} dB from its own run"
    res = {"requests": n, "dispatches": co["dispatches"], "k4_launches": co["launches"],
           "wall_s": co["wall_s"], "one_by_one_wall_s": alone["wall_s"], "min_psnr_db": worst}
    log(f"coalesced requests: {n} x 256x256 -> {n} x 1024x1024x3 in dispatches of {co['dispatches']} "
        f"({co['launches']} K4 launches), wall {co['wall_s']:.3f} s against {alone['wall_s']:.3f} s one "
        f"by one; lowest per-request PSNR against its own run {worst:.3f} dB (min 45) on {card}")
    return res


def run_tile_upscale(counters, card: str, conv_stack: int) -> dict:
    """tile_upscale over SRVGG on a (1, 720, 1280, 3) image, tile 256, pad
    10: 15 tiles of 276x276 through K4, against the same tiling with the
    layer-by-layer body.  Run at K4's deepest stack (4 layers a call, so
    4 chained launches), on a 276x276 tile that 16x16 tiles do not
    divide."""
    from sharkshark_tpu_torch.models import srvgg, torch_import
    from sharkshark_tpu_torch.ops import to_float
    from sharkshark_tpu_torch.upscale import tile_upscale

    dev = torch.device("cuda")
    params = torch_import.to_tensors(
        srvgg.from_torch(torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))), dev, torch.bfloat16)
    img = to_float(torch.from_numpy(make_frames(1, 720, 1280, seed=31)).to(dev)).to(torch.bfloat16)
    outs, times, launches = {}, {}, {}
    with torch.inference_mode():
        for L in (conv_stack, 0):
            def run():
                return tile_upscale(lambda p, x: srvgg.apply(p, x, conv_stack=L), params, img,
                                    tile=256, tile_pad=10)

            run()
            torch.cuda.synchronize()
            counters.reset()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times[L] = (time.perf_counter() - t0) * 1e3
            launches[L] = counters.read()["fused_conv_stack"]
            assert tuple(out.shape) == (1, 2880, 5120, 3), tuple(out.shape)
            assert torch.isfinite(out.float()).all()
            outs[L] = (out.float().clamp(0, 1) * 255).cpu().numpy()
    assert launches == {conv_stack: 32, 0: 0}, launches  # one K4 launch a body layer
    value = psnr(outs[conv_stack], outs[0])
    assert value >= 40.0, f"tiled K4 route is {value:.3f} dB from the layer-by-layer route"
    res = {"shape": [1, 2880, 5120, 3], "tiles": 15, "k4_launches": launches[conv_stack],
           "ms": times[conv_stack], "ms_layer_by_layer": times[0], "psnr_db": value}
    log(f"tile_upscale (1,720,1280,3) -> (1,2880,5120,3), 15 tiles of 276x276: conv_stack={conv_stack} "
        f"{times[conv_stack]:.3f} ms ({launches[conv_stack]} K4 launches), layer by layer {times[0]:.3f} ms, "
        f"PSNR between them {value:.3f} dB (min 40) on {card}")
    return res


def kernel_entry(bench, name: str, source: str, replaces: str, launches: int, rows: list[dict]) -> dict:
    """One kernel of the `kernels` line: per launch, averaged over `rows`
    (the shapes the path gives it), with the bound of that same work."""
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    b = bench.bound(sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows),
                    rows[0].get("peak_flops", bench.PEAK_BF16_FLOPS))
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("kernel_ms"), "kernel_ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": b["bound_ms"] / len(rows), "bound_by": b["bound_by"], "library_ms": mean("library_ms"),
        "shapes": rows,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "sharkshark_tpu_torch" / "csrc").is_dir() or not MINTED.is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sharkshark_tpu_torch.ops import _build
    from sharkshark_tpu_torch.ops import conv_stack as cs
    from sharkshark_tpu_torch.ops import tsm_conv as tsm
    from sharkshark_tpu_torch.ops import warp as wp
    from sharkshark_tpu_torch.tools import bench_backward_warp as bench_warp
    from sharkshark_tpu_torch.tools import bench_conv_stack as bench_cs
    from sharkshark_tpu_torch.tools import bench_tsm_conv as bench
    from sharkshark_tpu_torch.upscale import service as service_mod

    # 1. card and settings
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = Counters(tsm, wp, cs)
    from sharkshark_tpu_torch.models import srvgg

    # the service's routes for the production SRVGG; with the routes on,
    # K4 runs at its default depth
    defaults = {"tsm_pair": inspect.signature(service_mod.EsrganUpscalerService).parameters["tsm_pair"].default,
                "conv_stack": srvgg.resolve_conv_stack(srvgg.GENERAL_X4V3, None)}
    stack_l = srvgg.DEFAULT_CONV_STACK
    routes_on = {"tsm_pair": True, "conv_stack": stack_l}
    log(f"service defaults: {defaults}; routes on: {routes_on}")

    # 2. build
    t0 = time.perf_counter()
    sources = ["tsm_conv", "backward_warp", "conv_stack"]
    logs = _build.build(sources, verbose=True)
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions
    rows = [check_tsm_conv(tsm, bench, 64, 360, 640), check_tsm_conv(tsm, bench, 128, 180, 320)]
    pair_rows = [check_tsm_conv_pair(tsm, bench, 64, 360, 640), check_tsm_conv_pair(tsm, bench, 128, 180, 320)]
    warp_rows = check_backward_warp(bench_warp)
    stack_rows = [check_conv_stack(cs, bench_cs, L, bias) for L in (1, 2, 4) for bias in (True, False)]

    # 4. the denoise path: the service's defaults (the main path), both
    # routes on, and K1 alone with the layer-by-layer body as reference
    route_rows = time_denoise_routes(
        [{"tsm_pair": False, "conv_stack": 0}, {"tsm_pair": True, "conv_stack": 0}]
        + [{"tsm_pair": False, "conv_stack": L} for L in (1, 2, 4)] + [routes_on]
        + [{**defaults, "inplace": False}], card)
    main_res, main_out = run_main_path(service_mod, counters, card, **defaults)
    on_res, on_out = (main_res, main_out) if defaults == routes_on else run_main_path(
        service_mod, counters, card, **routes_on)
    ref_res, ref_out = run_main_path(service_mod, counters, card, tsm_pair=False, conv_stack=0)
    on_res["psnr_vs_k1_layer_by_layer_db"] = psnr(on_out, ref_out)
    log(f"denoise path, routes on vs K1 alone with the layer-by-layer body: PSNR "
        f"{on_res['psnr_vs_k1_layer_by_layer_db']:.3f} dB (min 40)")
    assert on_res["psnr_vs_k1_layer_by_layer_db"] >= 40.0, "the routes disagree with the K1-only route"

    # 5. whole step with the routes on, card against CPU
    step_psnr = check_step_against_cpu(counters, **routes_on)

    # 6. the EGVSR path, per frame (the default) and chunked
    egvsr_res, egvsr_out = run_egvsr_path(service_mod, counters, card)
    chunk_res, chunk_out = run_egvsr_path(service_mod, counters, card, chunked=True)
    chunk_res["psnr_vs_per_frame_db"] = psnr(chunk_out, egvsr_out)
    log(f"EGVSR chunked vs per-frame route on the card: PSNR {chunk_res['psnr_vs_per_frame_db']:.3f} dB "
        f"(min {PSNR_MIN})")
    assert chunk_res["psnr_vs_per_frame_db"] >= PSNR_MIN, "the chunked route disagrees with the per-frame one"

    # 7. EGVSR step, card against CPU
    egvsr_psnr = check_egvsr_step_against_cpu(wp)

    # 8. the CLI through the pipeline, then the paced end-to-end bench
    cli_res = run_cli(counters, card, defaults)
    e2e_rows = run_bench_e2e(card)

    # 9. the SR-only service, coalesced requests, tiled upscale (K4's paths)
    sr_res = run_sr_path(service_mod, counters, card, stack_l)
    sr_res["layer_by_layer"] = run_sr_path(service_mod, counters, card, 0)
    coalesce_res = run_coalesced_requests(service_mod, counters, card, stack_l)
    tile_res = run_tile_upscale(counters, card, cs.L_MAX)

    # the kernels line: launches from the main path's run, or, for a route
    # that is off by default, from the run with the routes on
    stack_row = next(r for r in stack_rows if r["layers"] == stack_l and r["bias"])
    # K3 at the EGVSR path's own case: a smooth flow, s2d_out=4, no cut
    warp_case = next(r for r in warp_rows if r["case"] == "smooth96 s2d4")
    kernels = [
        kernel_entry(bench, "tsm_conv", "sharkshark_tpu_torch/csrc/tsm_conv.cu",
                     "sharkshark_tpu/ops/pallas/tsm_conv.py:227", main_res["launches"]["tsm_conv"], rows),
        kernel_entry(bench, "tsm_conv_pair", "sharkshark_tpu_torch/csrc/tsm_conv.cu",
                     "sharkshark_tpu/ops/pallas/tsm_conv.py:502", on_res["launches"]["tsm_conv_pair"], pair_rows),
        kernel_entry(bench, "backward_warp", "sharkshark_tpu_torch/csrc/backward_warp.cu",
                     "sharkshark_tpu/ops/pallas/warp_band.py:262", egvsr_res["launches"], [warp_case]),
        kernel_entry(bench, "fused_conv_stack", "sharkshark_tpu_torch/csrc/conv_stack.cu",
                     "experiments/conv_stack.py:252", on_res["launches"]["fused_conv_stack"], [stack_row]),
    ]
    kernels[1]["note"] = "2 launches of K1 a call"
    kernels[2]["device_ms"] = warp_case["device_ms"]
    kernels[2]["cases"] = warp_rows
    kernels[2]["max_abs_err"] = max(r["max_abs_err"] for r in warp_rows)
    kernels[3]["cases"] = stack_rows
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} was not launched on its path"
    log(json.dumps({"defaults": defaults, "routes_on": routes_on, "route_timing": route_rows,
                    "main_path": main_res, "routes_on_path": on_res, "k1_layer_by_layer_path": ref_res,
                    "step_psnr_db": step_psnr, "egvsr_path": egvsr_res, "egvsr_chunked_path": chunk_res,
                    "egvsr_step_psnr_db": egvsr_psnr, "cli": cli_res, "bench_e2e": e2e_rows, "sr_path": sr_res,
                    "coalesced": coalesce_res, "tile": tile_res, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
