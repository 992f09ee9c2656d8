#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sharkshark_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs its main
path on the card.

    python3 chip_smoke.py

Every phase that drives a single-device service drives it through its
per-shape CUDA graphs (a step's signature runs eagerly once, is captured
at its second call and replays after), with the launch counts exact.

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
     minted weights), driven as the live pipeline drives it once two
     streams of warm-up dispatches have taken it through its graphs
     (every chunk of the timed stream but the drain's replays one), with
     the kernel launch counts read around each run: with the service's
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
 10. the model zoo and the other entry points at full width, 720p ->
     1440p, micro-batch 4, bf16, with seeded state dicts written to a
     temporary directory and passed by path: FSRCNN, RRDBNet
     RealESRGAN_x4plus (23 blocks, 64 features, growth 32; its apply
     alone beside its bound, with peak memory; the service with denoise
     off and on, the drain's frame count checked) and
     realesr-animevideov3 (16 K4 launches a call) through the service;
     animevideov3 with the default denoise and FSRCNN through the CLI,
     the output's bytes and the launches checked; each model on the card
     against the CPU by PSNR, with the reference's spread; upscale_image
     whole and in 256-pixel tiles; pipeline_folder (a child CLI on the
     card, then a skip);
 11. the HTTP image service at full width (SRVGG general-x4v3, the minted
     weights, bf16): the port's ImageBackend (memory cache) and a
     CacheFrontend on loopback ports; single uploads (1280x720 JPEG,
     500x375 RGBA PNG, mono PNG, 1600x1200, the 4096x2048 cap), each
     checked for status, type and size, with its wall time, the
     backend's spans, 32 K4 launches and, at the cap, peak memory; a
     small RGBA upload against the port's backend on the CPU in float32
     by PSNR; 8 concurrent uploads of one bucket in fewer dispatches,
     each against its lone run; a frontend miss and a hit of identical
     bytes; ~10 s of tools/load_test.py through the frontend (16 workers,
     8 images, no errors); the backend's CLI started as a user starts it;
 12. the training driver (python -m sharkshark_tpu_torch.train.driver)
     with the repo's three configs at their widths and crops (FRNet
     nf 64 nb 10, SRVGG 64 x 32, BSVD-32) on derived datasets written
     from seeded 640x640 stills: 30 iterations with a checkpoint every 10
     (TF32 at PyTorch's default; the mean loss of the last 10 below the
     first 10's, no kernel launched by the steps), each step through the
     driver's CUDA graph of the whole step (one a batch shape: SRVGG's
     partial last batch makes two),
     FRNet's with a periodic test at each checkpoint through one
     inference graph (K3 once a frame, replays included); a resume from
     the 20th; the step timed eager and through its graph in one call
     (step ms and host ms a call, medians of 10 after 3, the eager
     step's peak memory and the graph's pool); the graph against the
     eager step on six of the driver's batches (identical bit for bit
     under deterministic algorithms; with PyTorch's defaults beside two
     eager runs' own spread); the capturable Adam against the plain one
     over 30 updates on identical gradients (within 1e-4 of the distance
     moved); a resume on the card bit for bit under deterministic
     algorithms; one step's loss and gradients on the card (TF32 off)
     against the CPU (each leaf within 1e-3, or twice its own float32
     floor where higher); test mode with the minted weights (FRNet's on
     the card and the CPU, launching K3 once a frame), and profile mode
     (the inference's graph replayed);
 13. the GAN recipe through the driver (configs/tecogan_bd.yml at its
     widths: FRNet nf 64 nb 10, the spatio-temporal D, GT crop 128, batch
     4, T 10 -> 19 frames with ping-pong, BD, the five losses) on phase
     12's derived set at T 10, with its cuts listed: 30 iterations through
     the step's graph with a checkpoint every 10, G's and D's losses and
     the D updates (decided on the device), a resume from the 20th, the
     step timed eager and through its graph under the adaptive policy,
     and through its graph under 'always' and an adaptive threshold that
     never skips (the cost of the D blend), the graph against the eager
     step as in phase 12 (the D decisions among the logs), the
     capturable Adam against the plain one, a resume on the card bit for
     bit under deterministic algorithms, one step's losses, D decision
     and both networks' gradients on the card against the CPU (held in
     float64; float32, TF32 off, reported), and test mode through K3 (one
     launch a frame) on the card and the CPU, from the run's checkpoint
     and then from the minted FRNet through one inference cache (the
     second replays its graph); a short run with the spatial D and the
     VGG feature loss on a seeded VGG19 (its cost, not its quality), G
     from the minted FRNet; before these, ESPCN, VESPCN and SOF-VSR at
     their default configs on a 180x320 LR input, card against CPU and
     profile mode; after them, the export tools on phase 12's and 13's
     checkpoints, and quality_eval on the GAN test's frames;
 14. BSVD-64 and the rest of the denoise and SR library: K1 at BSVD-64's
     C=128 shape (T=4 at 360x640) against its plain version, timed with
     its bound and a cuDNN conv; the denoise service at 720p -> 1440p
     with BSVD-64 (seeded weights written by bsvd.to_torch, passed by
     path) and the minted SRVGG, 8 micro-batches of 4 and the drain
     (N + min(N, 16) frames, 8 K1 launches a chunk and none at C = 256,
     ms/frame, peak memory) and its step on the card against the CPU at a
     small size; upscale_single_denoise (the per-frame stream) over 24
     frames with the minted BSVD-32 (no K1 launch) against the chunked
     service's frames; srvgg.apply_down at d = 2, 3, 4 on a 720p frame
     through K4 against the layer-by-layer body; tools/export_model.py
     for srvgg and egvsr at 1x360x640x3, reloaded, against eager, with
     the K4 and K3 launches counted through the reloaded program;
 15. the multi-device serving paths (parallel/) at full width, 720p ->
     1440p, bf16, minted weights, on meshes of the cards where two or more
     are visible and of cuda:0 repeated otherwise (the bands then run one
     after another): the denoise service on a 1x4 mesh over 48 frames and
     the drain against the single-device service (PSNR >= 40 dB, 16 K1
     and 32 K4 launches a chunk on each band, by device too, ms/frame and
     peak memory per device), the SR-only service on a 2x2 mesh against
     one device, the EGVSR service on a 1x4 mesh against phase 6's
     single-device run (one K3 launch a band and frame: each band warps
     its columns of the whole previous HR frame), the CLI with --mesh 1,S
     (S the cards present, up to 4; 1,1 on one card, still through the
     sharded factories) with its exact bytes, and, with two or more
     cards, K1 and K4 against their plain versions on each card; K1 and
     K4 at the bands' shapes beside their plain versions, their bounds
     and the cuDNN calls, and K3 at the EGVSR bands (a column origin into
     the 2880x5120 frame) beside the plain gather, F.grid_sample and its
     bound, and bit for bit against the whole frame's warp.  Each mesh service
     runs twice over its frames, through its bands' CUDA graphs and
     through the factories' eager reference
     (parallel.sharded._eager_reference), held identical bit for bit,
     with the graphs held per band, the host's dispatch ms/frame (warm
     chunks, eager against replayed), the step's ms/frame back to back,
     the host ms of a step call split by part on an idle device, and the
     peak memory per device of each run;
 16. training over the mesh and the last tools: make_sharded_train_step
     at configs/egvsr_bd.yml's FRNet (nf 64, nb 10, BD, T 10, the minted
     weights), compiled (on one card the whole step one CUDA graph, on
     several cards per-band segment graphs), against the single-device
     step through its TrainStepCache, at its crop 128 and batch 4 on a
     data 2 x spatial 2 mesh and at crop 1024 and batch 2 on spatial 2
     (bands that cut), in float32 (TF32 off) and float64, each compared
     step a replay; the compiled sharded step against its eager step
     under deterministic algorithms (bit for bit on one card); ms a
     step, host ms a call, idle share, graphs held and peak memory of
     the single-device and sharded steps, eager and compiled;
     tools/warp_fidelity.py at 2160x3840 (three flows, three
     K3 launches); tools/ingest_weights.py on the minted SRVGG file and
     on two corrupted copies, which it must refuse; tools/bench_matrix.py
     --configs 3,0 --suites sr denoise --iters 2; tools/mint_lpips.py's
     training for 40 steps on seeded stills and its ranking check, on the
     card and the CPU;
 17. the single-device services' per-shape CUDA graphs
     (upscale/jit_cache.py), held against the eager step functions driven
     the same way on the same weights (identical bit for bit, or at least
     55 dB): the main path's denoise service (its defaults, 720p ->
     1440p, minted BSVD-32 and SRVGG, bf16) over 48 frames and the drain
     at micro-batch 4, as the live pipeline drives it (16 K1 and 32 K4
     launches a dispatch, delivered ms/frame over the replays), then a
     second stream after reset_stream one dispatch at a time (host ms a
     dispatch and the warm step's device ms/frame, eager and replayed;
     the warm step holds two graphs, one a ring phase), and at micro-batch
     8 with the SR tail in sub-batches of 4 (one warm graph); the SR-only
     service over 8 micro-batches of 4; the EGVSR service over phase 6's
     24 frames per frame (one K3 launch a frame) and chunked; each with
     its peak memory;
then one JSON line of kernel numbers, the card's name and power limit,
and the result line last.  Exits 2 without a result when CUDA is
unavailable or the script stands outside the repo checkout.

    python3 chip_smoke.py --mesh-only

runs phases 1, 2, phase 6's per-frame EGVSR service, phase 15 and
phase 16's sharded train step alone (on a machine with several cards:
the bands on distinct cards), prints their JSON and the card line, and
no result line.

    python3 chip_smoke.py --train-only

runs phases 1, 2, 12 and 13 alone, prints their JSON and the card line,
and no result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import io
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
        f"kernel {row['kernel_ms']:.4f} ms a call, {row['device_ms']:.4f} ms back to back; plain "
        f"{row['plain_ms']:.4f} ms; one cuDNN conv on the built mix {row['library_ms']:.4f} ms a call, "
        f"{row['library_device_ms']:.4f} ms back to back; bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{100 * row['bound_share']:.1f}% of it back to back; {row['blocks']} persistent blocks for "
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
    def kernel():
        return tsm.tsm_conv_pair(*args)

    def library():
        return F.conv2d(mix1, w1_oihw, b1, padding=1), F.conv2d(mix2, w2_oihw, b2, padding=1)

    flops = 2 * 2 * 9 * c * c * h * w * t
    nbytes = nbytes_of(x, *carries, w1, b1, w2, b2, got_y2, got_carry)
    row = {
        "c": c, "h": h, "w": w, "t": t, "max_abs_err": max_err,
        "kernel_ms": bench.time_ms(kernel), "device_ms": bench.device_ms(kernel),
        "two_k1_ms": bench.time_ms(two_k1), "plain_ms": bench.time_ms(lambda: tsm.tsm_conv_pair_plain(*args)),
        "library_ms": bench.time_ms(library), "library_device_ms": bench.device_ms(library),
        "flops": flops, "bytes": nbytes, **bench.bound(flops, nbytes),
    }
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    log(f"tsm_conv_pair C={c} {h}x{w} T={t}: max|err| {max_err:.4g} (rtol=atol={bench.TOL}); "
        f"kernel {row['kernel_ms']:.4f} ms a call, {row['device_ms']:.4f} ms back to back; two tsm_conv "
        f"calls {row['two_k1_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; two cuDNN convs on the built "
        f"mixes {row['library_ms']:.4f} ms a call, {row['library_device_ms']:.4f} ms back to back; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), {100 * row['bound_share']:.1f}% of it back to back")
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
        f"kernel {row['kernel_ms']:.4f} ms a call, {row['device_ms']:.4f} ms back to back; plain "
        f"{row['plain_ms']:.4f} ms; conv2d+bias+prelu route {row['library_ms']:.4f} ms a call, "
        f"{row['library_device_ms']:.4f} ms back to back; bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"{100 * row['bound_share']:.1f}% of it back to back; {n_layers} launches of {row['blocks']} blocks "
        f"for {row['tiles']} tiles")
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


def make_frames(n: int, h: int, w: int, seed: int, pan: int = 3) -> np.ndarray:
    """A smooth random scene panning `pan` px right and 1 px down per
    frame (up to 128 px in all), with fresh sensor noise on every frame."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 16 + 8, w // 16 + 8, 3), dtype=np.float32)
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(coarse).permute(2, 0, 1)[None], scale_factor=16, mode="bicubic",
        align_corners=False)[0].permute(1, 2, 0).numpy()
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        view = scene[i : i + h, pan * i : pan * i + w]
        noisy = view * 200 + 28 + rng.normal(0, 6, view.shape)
        out[i] = np.clip(noisy, 0, 255).astype(np.uint8)
    return out


class Counters:
    """The launch counts of every kernel wrapper, set to 0 and read as one."""

    def __init__(self, tsm, wp, cs):
        self.tsm, self.wp, self.cs = tsm, wp, cs

    def reset(self) -> None:
        self.tsm.launches = self.tsm.pair_launches = self.wp.launches = self.cs.launches = 0
        self.tsm.launches_by_device.clear()
        self.cs.launches_by_device.clear()

    def by_device(self) -> dict:
        """K1's and K4's launches by CUDA device index."""
        return {"tsm_conv": dict(self.tsm.launches_by_device),
                "fused_conv_stack": dict(self.cs.launches_by_device)}

    def read(self) -> dict:
        return {"tsm_conv": self.tsm.launches, "tsm_conv_pair": self.tsm.pair_launches,
                "backward_warp": self.wp.launches, "fused_conv_stack": self.cs.launches}


def k1_per_chunk(bsvd_cfg) -> int:
    """K1 launches of one chunk: each DenBlock's shift convs at the widths
    K1 is built for, 4 a width (two mem blocks of two convs); BSVD-32's 16
    (C = 64, 128), BSVD-64's 8 (C = 128; its C = 256 take the
    shift-and-concatenate conv)."""
    from sharkshark_tpu_torch.ops import tsm_conv as tsm

    return 2 * sum(4 for c in bsvd_cfg.chns[1:] if c in tsm.KERNEL_CHANNELS)


def denoise_launches(cold: int, warm: int, flush: int, tsm_pair: bool, conv_stack: int,
                     body_layers: int = 32, k1: int = 16) -> dict:
    """Kernel launches that a run of the denoise path implies: k1 K1 per
    chunk (16 for BSVD-32), with tsm_pair too (a warm chunk's K2 calls
    make 2 each), and one K4 a body layer per SRVGG apply (one per chunk;
    32 for general-x4v3, 16 for animevideov3) with any conv_stack = L > 0."""
    chunks = cold + warm + flush
    return {"tsm_conv": k1 * chunks,
            "tsm_conv_pair": k1 // 2 * warm if tsm_pair else 0, "backward_warp": 0,
            "fused_conv_stack": chunks * body_layers if conv_stack else 0}


def run_main_path(service_mod, counters, card: str, tsm_pair: bool, conv_stack: int,
                  jobs: int = 8, batch: int = 4, denoise_weights: str = str(MINTED / "bsvd-derived-32.pth"),
                  bsvd_cfg=None) -> tuple[dict, np.ndarray]:
    from sharkshark_tpu_torch.models import bsvd
    from sharkshark_tpu_torch.runtime import EOF

    bsvd_cfg = bsvd_cfg or bsvd.BSVD_32
    route = f"tsm_pair={tsm_pair}, conv_stack={conv_stack}"
    if bsvd_cfg != bsvd.BSVD_32:
        route += f", BSVD chns {bsvd_cfg.chns}"
    svc = service_mod.EsrganUpscalerService(
        lr_level=3, output_shape=(1440, 2560), denoising=True, denoise_rate=0.75,
        batch_size=batch, weights=str(MINTED / "srvgg-derived-x4.pth"),
        denoise_weights=denoise_weights, bsvd_cfg=bsvd_cfg, tsm_pair=tsm_pair, conv_stack=conv_stack,
    )
    frames = make_frames(jobs * batch, 720, 1280, seed=7)
    got, stamps = [], []

    def on_queue(entry):
        stamps.append(time.perf_counter())
        got.append(entry)

    # two streams of warm-up dispatches, as a server that has served two
    # streams: the first runs each step eagerly once and captures the
    # warm step's graphs, the second captures the cold chunks' (keyed by
    # their frame index); the timed stream replays every chunk but the
    # drain's (keyed by the stream's length, seen there first)
    svc.warm_up()
    warmed = graph_counts(svc)
    svc.on_queue = on_queue
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    want = denoise_launches(first_warm, jobs - first_warm, bsvd.SHIFT_NUM // batch, tsm_pair, conv_stack,
                            k1=k1_per_chunk(bsvd_cfg))
    assert launches == want, f"denoise path ({route}): launches {launches}, expected {want}"
    last = outs[jobs - 1]
    assert last.std() > 5, "the output frames are flat"
    graphs = graph_counts(svc)
    for name in ("cold_step", "warm_step"):
        assert graphs[name]["graphs"] == warmed[name]["graphs"] > 0, f"{name} did not replay: {warmed} -> {graphs}"
    # deliveries 0..jobs-1 are the live batches; batches >= SHIFT_NUM/batch
    # replayed the warm step's graphs, and with the in-flight ring each
    # delivery waits for its own step, so their spacing is its time
    warm_s = (stamps[jobs - 1] - stamps[first_warm - 1]) / ((jobs - first_warm) * batch)
    res = {"route": route, "frames": total, "launches": launches, "chunks": jobs + bsvd.SHIFT_NUM // batch,
           "wall_s": wall, "warm_ms_per_frame": warm_s * 1e3, "warm_fps": 1.0 / warm_s, "peak_mem_gb": peak_gb,
           "graphs": graphs}
    log(f"denoise path ({route}): {total} frames of 1440x2560x3 uint8 ({n_live} live + {n_drained} "
        f"drained), launches {launches}, wall {wall:.3f} s, peak memory {peak_gb:.3f} GB")
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


def check_step_against_cpu(counters, tsm_pair: bool, conv_stack: int,
                           den_path: str = str(MINTED / "bsvd-derived-32.pth"), bsvd_cfg=None) -> float:
    from sharkshark_tpu_torch.models import bsvd, srvgg, torch_import
    from sharkshark_tpu_torch.upscale import steps

    bsvd_cfg = bsvd_cfg or bsvd.BSVD_32
    lr_shape, out_shape, t, chunks = (64, 96), (128, 192), 4, 6
    frames = make_frames(t * chunks, *lr_shape, seed=11)
    sd_sr = torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))
    sd_den = torch_import.load_state_dict(den_path)

    def run(device, dtype):
        spec = steps.UpscaleSpec(lr_shape=lr_shape, output_shape=out_shape,
                                 denoise_rate=0.75, compute_dtype=dtype)
        params = torch_import.to_tensors(
            {"sr": srvgg.from_torch(sd_sr), "denoise": bsvd.from_torch(sd_den)}, device, dtype)

        def sr_apply(p, x):
            return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=conv_stack)

        state = steps.init_denoise_state(1, spec, bsvd_cfg, device=device)
        outs = []
        with torch.inference_mode():
            for i in range(chunks):
                out, state = steps.upscale_batch_denoise(
                    sr_apply, params, state, torch.from_numpy(frames[i * t : (i + 1) * t]).to(device),
                    spec, bsvd_cfg, warm=state["t"] >= bsvd.SHIFT_NUM, tsm_pair=tsm_pair)
                outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    counters.reset()
    card = run(torch.device("cuda"), torch.bfloat16)
    want = denoise_launches(4, chunks - 4, 0, tsm_pair, conv_stack, k1=k1_per_chunk(bsvd_cfg))
    assert counters.read() == want, f"the card's step launched {counters.read()}, expected {want}"
    cpu = run(torch.device("cpu"), torch.float32)
    value = psnr(card, cpu)
    log(f"whole step (tsm_pair={tsm_pair}, conv_stack={conv_stack}, BSVD chns {bsvd_cfg.chns}), card bf16 vs CPU float32 at "
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
           "ms_per_frame": per_frame_s * 1e3, "fps": 1.0 / per_frame_s, "graphs": graph_counts(svc)}
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


@contextlib.contextmanager
def fake_ffmpeg(n: int):
    """A temporary directory (inside the build directory) whose `ffmpeg`
    runs tests/fake_ffmpeg.py, set as the stream layer's binary, feeding
    n frames of the source quality."""
    build = ROOT / "sharkshark_tpu_torch" / "build"
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        fake = Path(tmp) / "ffmpeg"
        fake.write_text(f'#!/bin/sh\nexec "{sys.executable}" "{ROOT / "tests" / "fake_ffmpeg.py"}" "$@"\n')
        fake.chmod(0o755)
        os.environ["SHARKSHARK_FFMPEG"] = str(fake)
        os.environ["FAKE_FFMPEG_FRAMES"] = str(n)
        yield Path(tmp)


def run_cli(counters, card: str, runs: list, n: int = 24) -> list[dict]:
    """The port's CLI, through the pipeline and the stream layer, with
    tests/fake_ffmpeg.py standing in for ffmpeg: 24 frames of 720p60 in
    (the lr_shape, so no host resize), a raw 1440x2560 rgb24 file out.
    runs: (name, extra flags, frames out, kernel launches) each."""
    from sharkshark_tpu_torch.main import upscaler

    frame_bytes = 1440 * 2560 * 3
    results = []
    with fake_ffmpeg(n) as tmp:
        src = tmp / "source.mp4"
        src.write_bytes(b"")
        for name, extra, frames_out, want_launches in runs:
            out = tmp / f"{name}.raw"
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


def main_cli_runs(defaults: dict, n: int = 24) -> list:
    egvsr_launches = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": n, "fused_conv_stack": 0}
    return [
        ("egvsr", ["--model", "egvsr", "--weights", str(MINTED / "egvsr-derived-x4.pth")], n, egvsr_launches),
        # micro-batches of 4: 4 cold chunks, then warm ones, then 4 flush chunks
        ("realesrgan+denoise", ["--weights", str(MINTED / "srvgg-derived-x4.pth"),
                                "--denoise-weights", str(MINTED / "bsvd-derived-32.pth")],
         n + min(n, 16), denoise_launches(4, n // 4 - 4, 4, **defaults)),
    ]


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
    patched = "upscale_dispatch" in vars(svc)
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
    if patched:
        svc.upscale_dispatch = orig
    else:
        del svc.upscale_dispatch
    assert svc._error is None and not svc.is_alive, f"service failed: {svc._error!r}"
    assert isinstance(got[-1], EOF), got[-1]
    return got[:-1], stamps[:-1], dispatched


def run_sr_path(service_mod, counters, card: str, conv_stack: int | None, jobs: int = 8, batch: int = 4,
                model: str = "realesrgan", weights: str = str(MINTED / "srvgg-derived-x4.pth"),
                body_layers: int = 32) -> dict:
    """The SR-only service (--no-denoise: steps.upscale_multi with the
    local color match) at 720p -> 1440p with `model`, an SRVGG body
    (body_layers deep) through K4 where conv_stack resolves to L > 0.
    One micro-batch runs first as a warm-up; the device's peak memory is
    read over the timed run."""
    svc = service_mod.EsrganUpscalerService(
        lr_level=3, output_shape=(1440, 2560), denoising=False, batch_size=batch,
        upscaler_model=model, weights=weights, conv_stack=conv_stack)
    svc.proc_init()
    frames = make_frames(jobs * batch, 720, 1280, seed=23)
    svc.upscale(frames[:batch])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
            "fused_conv_stack": jobs * body_layers if svc.conv_stack else 0}
    assert launches == want, f"SR-only path ({model}): launches {launches}, expected {want}"
    # from the second delivery on, their spacing is the step's time; a step
    # of many more launches than the CUDA launch queue holds (RRDBNet's
    # ~1,100) blocks the host while it enqueues the next micro-batch and
    # so delays the first delivery: read the wall time per frame there
    per_frame_s = (stamps[-1] - stamps[0]) / ((jobs - 1) * batch)
    res = {"model": model, "frames": jobs * batch, "conv_stack": svc.conv_stack, "launches": launches,
           "wall_s": wall, "ms_per_frame": per_frame_s * 1e3, "fps": 1.0 / per_frame_s,
           "wall_ms_per_frame": wall / (jobs * batch) * 1e3, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"SR-only path ({model}, conv_stack={svc.conv_stack}): {jobs * batch} frames of 1440x2560x3 uint8, "
        f"launches {launches}, wall {wall:.3f} s ({res['wall_ms_per_frame']:.3f} ms a frame); "
        f"{res['ms_per_frame']:.3f} ms/frame between deliveries, {res['fps']:.3f} frames/s (batch {batch}), "
        f"peak device memory {res['peak_mem_gb']:.2f} GB on {card}")
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


# -------------------------------------------------------------- phase 10


def write_zoo_weights(tmp: Path) -> dict:
    """Seeded state dicts in the reference key layout, written as .pth:
    FSRCNN (its deconv drawn 60x wider than the reference's init of std
    0.001, which leaves the output a near-constant, and a 0.5 bias),
    RRDBNet RealESRGAN_x4plus at its published config (conv_last scaled
    by 0.004 with a 0.5 bias: the random trunk's features grow to a
    spread of ~50, and so the output spreads ~0.2 around 0.5 instead of
    saturating) and realesr-animevideov3."""
    from sharkshark_tpu_torch.models import fsrcnn, rrdbnet, srvgg

    fp = fsrcnn.init_params(torch.Generator().manual_seed(40))
    fp["deconv"] = {"w": fp["deconv"]["w"] * 60, "b": torch.full((1,), 0.5)}
    rp = rrdbnet.init_params(torch.Generator().manual_seed(41), rrdbnet.X4PLUS)
    rp["conv_last"] = {"w": rp["conv_last"]["w"] * 0.004, "b": torch.full((3,), 0.5)}
    sds = {
        "fsrcnn": fsrcnn.to_torch(fp),
        "RealESRGAN_x4plus": rrdbnet.to_torch(rp),
        "realesr-animevideov3": srvgg.to_torch(
            srvgg.init_params(torch.Generator().manual_seed(42), srvgg.ANIMEVIDEO_V3)),
    }
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(tmp / f"{name}.pth")
        torch.save({"params_ema": sd}, paths[name])
    return paths


def time_rrdb_apply(bench, card: str, path: str, batch: int = 4) -> dict:
    """RRDBNet x4plus's apply alone on a (4, 720, 1280, 3) bf16 batch,
    CUDA events around 3 calls after a warm-up, beside its bound by
    operations, with the device's peak memory over the calls."""
    from sharkshark_tpu_torch.models import rrdbnet, torch_import
    from sharkshark_tpu_torch.tools.profile_rrdb import flops_per_frame

    dev = torch.device("cuda")
    params = torch_import.to_tensors(rrdbnet.from_torch(torch_import.load_state_dict(path)), dev, torch.bfloat16)
    x = torch.from_numpy(make_frames(batch, 720, 1280, seed=43)).to(dev).to(torch.bfloat16) / 255
    with torch.inference_mode():
        out = rrdbnet.apply(params, x)
        assert tuple(out.shape) == (batch, 2880, 5120, 3) and torch.isfinite(out.float()).all()
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the weights, the input and earlier phases' tensors
        ms = bench.time_ms(lambda: rrdbnet.apply(params, x), reps=3, warmup=0) / batch
    flops = flops_per_frame(rrdbnet.X4PLUS, 720, 1280)
    bound_ms = flops / bench.PEAK_BF16_FLOPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    res = {"ms_per_frame": ms, "tflop_per_frame": flops / 1e12, "bound_ms": bound_ms,
           "bound_share": bound_ms / ms, "peak_mem_gb": peak / 1e9, "apply_mem_gb": (peak - held) / 1e9}
    log(f"RRDBNet x4plus apply (23 blocks, nf 64, gc 32), (4,720,1280,3) -> (4,2880,5120,3) bf16: "
        f"{ms:.3f} ms/frame, {flops / 1e12:.2f} TFLOP a frame, bound {bound_ms:.3f} ms (operations), "
        f"{100 * res['bound_share']:.1f}% of the bound; peak device memory {res['peak_mem_gb']:.2f} GB, "
        f"{res['apply_mem_gb']:.2f} GB of it the apply's own on {card}")
    return res


def run_rrdb_denoise(service_mod, counters, card: str, path: str, jobs: int = 2, batch: int = 4) -> dict:
    """RRDBNet x4plus behind the BSVD denoiser (the CLI's default), 720p ->
    1440p: `jobs` micro-batches, then the EOF drain; N + min(N, 16)
    frames out, 16 K1 launches a chunk and no K4."""
    from sharkshark_tpu_torch.models import bsvd

    svc = service_mod.EsrganUpscalerService(
        upscaler_model="RealESRGAN_x4plus", lr_level=3, output_shape=(1440, 2560), denoising=True,
        denoise_rate=0.75, batch_size=batch, weights=path,
        denoise_weights=str(MINTED / "bsvd-derived-32.pth"))
    svc.proc_init()
    frames = make_frames(jobs * batch, 720, 1280, seed=44)
    counters.reset()
    t0 = time.perf_counter()
    got, _, _ = drive(svc, service_mod.UpscalerQueueEntry, [frames[i * batch : (i + 1) * batch] for i in range(jobs)])
    wall = time.perf_counter() - t0
    launches = counters.read()
    n = jobs * batch
    total = sum(len(e.frames) for e in got)
    assert total == n + min(n, bsvd.SHIFT_NUM), f"emitted {total} frames, expected {n + min(n, bsvd.SHIFT_NUM)}"
    for e in got:
        assert e.frames.dtype == np.uint8 and e.frames.shape[1:] == (1440, 2560, 3), e.frames.shape
    chunks = jobs + bsvd.SHIFT_NUM // batch
    want = denoise_launches(jobs, 0, bsvd.SHIFT_NUM // batch, False, 0)
    assert launches == want, f"RRDBNet denoise path: launches {launches}, expected {want}"
    res = {"frames": total, "chunks": chunks, "launches": launches, "wall_s": wall,
           "ms_per_frame_out": wall / total * 1e3}
    log(f"RRDBNet x4plus + BSVD denoise: {n} frames in, {total} out ({n} live + {total - n} drained), "
        f"{chunks} chunks, launches {launches}, wall {wall:.3f} s ({res['ms_per_frame_out']:.3f} ms a frame out, "
        f"cold chunks and drain included) on {card}")
    return res


def check_zoo_against_cpu(counters, paths: dict, lr_shape=(32, 48)) -> list[dict]:
    """Each new model's apply on the card (bf16) against the port on the
    CPU (float32) at a small size, by PSNR over the outputs clamped to
    [0, 1], with the CPU output's standard deviation: FSRCNN (RGB riding
    the batch), RRDBNet x4plus with all 23 blocks and animevideov3 (its
    body through K4, 16 launches a call)."""
    from sharkshark_tpu_torch.models import fsrcnn, rrdbnet, srvgg, torch_import

    img = make_frames(2, *lr_shape, seed=45).astype(np.float32) / 255
    models = [
        ("fsrcnn", fsrcnn.from_torch, lambda p, x: fsrcnn.apply_rgb(p, x), 0),
        ("RealESRGAN_x4plus", rrdbnet.from_torch, lambda p, x: rrdbnet.apply(p, x), 0),
        ("realesr-animevideov3", lambda sd: srvgg.from_torch(sd, srvgg.ANIMEVIDEO_V3),
         lambda p, x: srvgg.apply(p, x, cfg=srvgg.ANIMEVIDEO_V3,
                                  conv_stack=srvgg.resolve_conv_stack(srvgg.ANIMEVIDEO_V3, None)), 16),
    ]
    rows = []
    for name, load, fn, k4 in models:
        sd = torch_import.load_state_dict(paths[name])
        outs = {}
        for dev, dtype in ((torch.device("cuda"), torch.bfloat16), (torch.device("cpu"), torch.float32)):
            params = torch_import.to_tensors(load(sd), dev, dtype)
            counters.reset()
            with torch.inference_mode():
                out = fn(params, torch.from_numpy(img).to(dev, dtype))
            outs[dev.type] = out.float().clamp(0, 1).cpu().numpy()
            if dev.type == "cuda":
                assert counters.read()["fused_conv_stack"] == k4, f"{name}: {counters.read()}, {k4} K4 expected"
        ref_std = float(outs["cpu"].std())
        value = psnr(outs["cuda"] * 255, outs["cpu"] * 255)
        rows.append({"model": name, "lr_shape": list(lr_shape), "psnr_db": value, "ref_std": ref_std,
                     "k4_launches": k4})
        log(f"{name}, card bf16 vs CPU float32 at {lr_shape} x2 frames: PSNR {value:.3f} dB (min {PSNR_MIN}), "
            f"CPU output std {ref_std:.4f} (min 0.05), {k4} K4 launches")
        assert ref_std >= 0.05, f"{name}: the reference output is near-constant (std {ref_std:.4f})"
        assert value >= PSNR_MIN, f"{name}: PSNR {value:.3f} dB below {PSNR_MIN}"
    return rows


def run_upscale_image(card: str, path: str) -> dict:
    """upscale_image's compute function (FSRCNN, the CLI's default model)
    on a 720x1280 image, whole and in 256-pixel tiles with 10 pixels of
    context, the tiled result held against the whole one by PSNR."""
    from sharkshark_tpu_torch.main import upscale_image

    img = make_frames(1, 720, 1280, seed=46)[0].astype(np.float32) / 255
    outs, times = {}, {}
    for tile in (0, 256):
        upscale_image.upscale_array(img[:64, :64], weights=path, tile=tile)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[tile] = upscale_image.upscale_array(img, weights=path, tile=tile, tile_pad=10)
        times[tile] = (time.perf_counter() - t0) * 1e3
        assert outs[tile].shape == (2880, 5120, 3) and np.isfinite(outs[tile]).all()
    value = psnr(outs[256] * 255, outs[0] * 255)
    res = {"shape": [720, 1280, 3], "ms_whole": times[0], "ms_tiled": times[256], "psnr_db": value,
           "std": float(outs[0].std())}
    log(f"upscale_image.upscale_array FSRCNN 720x1280 -> 2880x5120 bf16: whole {times[0]:.3f} ms, 15 tiles "
        f"of 256 {times[256]:.3f} ms (host clock, weight loading included), PSNR tiled vs whole {value:.3f} dB "
        f"(min 40), output std {res['std']:.4f} on {card}")
    assert value >= 40.0, f"tiled upscale_image is {value:.3f} dB from the whole image"
    return res


def run_pipeline_folder(card: str, path: str, n: int = 8) -> dict:
    """pipeline_folder over a directory with one fake video: the child CLI
    (FSRCNN, no denoise, on the card) writes '[SS4] clip.flv'; a second
    run skips it."""
    from sharkshark_tpu_torch.main import pipeline_folder

    with fake_ffmpeg(n) as tmp:
        videos = tmp / "videos"
        videos.mkdir()
        (videos / "clip.mp4").write_bytes(b"")
        argv = ["--dir", str(videos), "--model", "fsrcnn", "--no-denoise", "--weights", path,
                "--quality", "720p60", "--no-overlay"]
        t0 = time.perf_counter()
        pipeline_folder.main(argv)
        wall = time.perf_counter() - t0
        out = videos / "[SS4] clip.flv"
        size = out.stat().st_size
        assert size == n * 1440 * 2560 * 3, f"pipeline_folder wrote {size} bytes"
        mtime = out.stat().st_mtime_ns
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pipeline_folder.main(argv)
        assert "skip (exists)" in buf.getvalue() and out.stat().st_mtime_ns == mtime, buf.getvalue()
    log(f"pipeline_folder: one video, {n} frames -> '[SS4] clip.flv' ({size} bytes) in {wall:.3f} s "
        f"(a child process on the card); the second run skipped it, on {card}")
    return {"frames": n, "bytes": size, "wall_s": wall}


def run_zoo_phase(service_mod, counters, bench, card: str) -> dict:
    """Phase 10: FSRCNN, RRDBNet x4plus and realesr-animevideov3 at 720p ->
    1440p, micro-batch 4, bf16, with seeded weights passed by path."""
    from sharkshark_tpu_torch.models import bsvd

    res = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "sharkshark_tpu_torch" / "build") as tmp:
        paths = write_zoo_weights(Path(tmp))
        # (a) FSRCNN through the SR-only service
        res["fsrcnn"] = run_sr_path(service_mod, counters, card, None, model="fsrcnn", weights=paths["fsrcnn"])
        # (b) RRDBNet x4plus: the apply alone, then the service without and
        # with the denoiser
        res["rrdb_apply"] = time_rrdb_apply(bench, card, paths["RealESRGAN_x4plus"])
        res["rrdb_sr"] = run_sr_path(service_mod, counters, card, None, jobs=2, model="RealESRGAN_x4plus",
                                     weights=paths["RealESRGAN_x4plus"])
        res["rrdb_sr"]["bound_share"] = res["rrdb_apply"]["bound_ms"] / res["rrdb_sr"]["wall_ms_per_frame"]
        log(f"RRDBNet x4plus SR-only service: {res['rrdb_sr']['wall_ms_per_frame']:.3f} ms a frame (wall), "
            f"{100 * res['rrdb_sr']['bound_share']:.1f}% of the model's bound")
        # animevideov3 through the SR-only service: 16 K4 launches a call
        res["animevideov3"] = run_sr_path(service_mod, counters, card, None, model="realesr-animevideov3",
                                          weights=paths["realesr-animevideov3"], body_layers=16)
        res["rrdb_denoise"] = run_rrdb_denoise(service_mod, counters, card, paths["RealESRGAN_x4plus"])
        # (c) the CLI: animevideov3 with the default denoise (6 live chunks
        # + 4 flush chunks, 16 K4 a chunk), FSRCNN without
        n, chunks = 24, 24 // 4 + bsvd.SHIFT_NUM // 4
        res["cli"] = run_cli(counters, card, [
            ("realesr-animevideov3+denoise",
             ["--model", "realesr-animevideov3", "--weights", paths["realesr-animevideov3"],
              "--denoise-weights", str(MINTED / "bsvd-derived-32.pth")],
             n + min(n, 16), denoise_launches(4, n // 4 - 4, 4, False, 1, body_layers=16)),
            ("fsrcnn", ["--model", "fsrcnn", "--no-denoise", "--weights", paths["fsrcnn"]], n,
             {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": 0, "fused_conv_stack": 0}),
        ], n=n)
        av3 = res["cli"][0]["launches"]
        log(f"realesr-animevideov3 through the CLI: {av3['fused_conv_stack'] / chunks:.0f} K4 launches an SR call "
            f"over {chunks} chunks, {av3['tsm_conv']} K1 launches")
        # (d) card against CPU; (e) upscale_image; (f) pipeline_folder
        res["card_vs_cpu"] = check_zoo_against_cpu(counters, paths)
        res["upscale_image"] = run_upscale_image(card, paths["fsrcnn"])
        res["pipeline_folder"] = run_pipeline_folder(card, paths["fsrcnn"])
    return res


# -------------------------------------------------------------- phase 11


def encode_image(arr: np.ndarray, fmt: str, mode: str | None = None) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt)
    return buf.getvalue()


def decode_image(data: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(data))


def request_sizes(w: int, h: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """For a w x h upload: the (height, width) of the bucket that the
    backend hands the service (the pre-scale, then padding up to the
    64-pixel grid, or the crop to it at the cap), and the (width, height)
    of its answer (the unpadded or cropped size, 4x, the post-scale;
    cv2.resize rounds its fx/fy sizes to nearest, ties to even, as
    Python's round)."""
    from sharkshark_tpu_torch.image_server import backend as backend_mod

    pre, post = backend_mod.ImageBackend._scales(h, w)
    if pre < 1.0:
        w, h = round(w * pre), round(h * pre)
    b = backend_mod.SHAPE_BUCKET
    bucket = (-(-h // b) * b, -(-w // b) * b)
    if bucket[0] * bucket[1] > backend_mod.MAX_PIXELS:
        w, h = max(b, w // b * b), max(b, h // b * b)
        bucket = (h, w)
    w, h = 4 * w, 4 * h
    if post < 1.0:
        w, h = round(w * post), round(h * post)
    return bucket, (w, h)


def expected_out_size(w: int, h: int) -> tuple[int, int]:
    """(width, height) of the backend's answer to a w x h upload."""
    return request_sizes(w, h)[1]


def check_k4_at_image_shapes(bench_cs, shapes: list[tuple[int, int, int]], card: str) -> list[dict]:
    """K4 (L = 1 with bias, as the service runs it) against
    fused_conv_stack_plain on the card at every (n, h, w, 64) that the
    image path gave it, within phase 3's tolerance (0.02 x max(|ref|max,
    1)) on seeded inputs, then timed beside the plain version, the
    layer-by-layer route and the bound (bench_conv_stack.measure)."""
    rows = []
    for shape in shapes:
        row = bench_cs.measure(1, True, shape=shape, reps=5)
        rows.append({k: row[k] for k in ("shape", "max_abs_err", "ref_max", "kernel_ms", "device_ms", "plain_ms",
                                         "library_ms", "library_device_ms", "bound_ms", "bound_by")})
        log(f"fused_conv_stack at the image path's {tuple(row['shape'])}: max|err| {row['max_abs_err']:.4g} "
            f"(limit {bench_cs.TOL * max(row['ref_max'], 1.0):.4g}); kernel {row['kernel_ms']:.4f} ms a call, "
            f"{row['device_ms']:.4f} ms back to back; plain {row['plain_ms']:.4f} ms; conv2d+bias+prelu route "
            f"{row['library_ms']:.4f} ms a call, {row['library_device_ms']:.4f} ms back to back; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}) on {card}")
    return rows


# the backend's per-request spans (runtime.Profiler, seconds), in order
SPANS = ("endpoint.io.read", "endpoint.io.imdecode", "upscaler.upscale", "upscaler.fetch", "endpoint.proc",
         "endpoint.write")


def run_image_service(counters, card: str) -> dict:
    """Phase 11: the port's HTTP image service on the card.  The backend
    (SRVGG general-x4v3 with the minted weights, bf16, K4 one layer a
    launch, memory cache) and a cache frontend in front of it, on
    loopback ports; single requests of five kinds (sizes, content type,
    K4 launches, wall ms, the cap's peak memory), one small RGBA request
    against the port's backend on the CPU in float32, 8 concurrent
    requests of one bucket against their lone runs, a frontend miss and
    hit, ~10 s of tools/load_test.py through the frontend (8 images, so
    all but 8 requests are the frontend's cache hits) and a load run of
    distinct images (every request a miss that reaches the card); then
    K4 against its plain version at every shape the phase gave it."""
    import concurrent.futures
    import threading

    from sharkshark_tpu_torch.image_server import CacheFrontend, ImageBackend, serve_background
    from sharkshark_tpu_torch.image_server.http_util import post_file
    from sharkshark_tpu_torch.tools import bench_conv_stack as bench_cs
    from sharkshark_tpu_torch.tools import load_test
    from sharkshark_tpu_torch.upscale.service import EsrganUpscalerService

    t_phase = time.perf_counter()
    weights = str(MINTED / "srvgg-derived-x4.pth")
    servers, services = [], []

    def serve(app) -> str:
        httpd = serve_background(app, port=0)
        servers.append(httpd)
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    def backend(**kw):
        b = ImageBackend(**kw)
        services.append(b)
        return b, serve(b.app)

    def k4_only(launches: dict, n: int, what: str) -> None:
        others = {k: v for k, v in launches.items() if k != "fused_conv_stack" and v}
        assert launches["fused_conv_stack"] == n and not others, f"{what}: launches {launches}, {n} K4 expected"

    # K4's launches over the whole phase, across the per-step resets
    k4_total = [0]

    def step_reset() -> None:
        k4_total[0] += counters.read()["fused_conv_stack"]
        counters.reset()

    # the (n, h, w) of every K4 call on the card in this phase (SRVGG's
    # body calls it through the module), held against the plain version
    # at the end
    cs = counters.cs
    k4_call, k4_shapes = cs.fused_conv_stack, set()

    def recording(x, *args, **kw):
        if x.device.type == "cuda":
            k4_shapes.add(tuple(x.shape[:3]))
        return k4_call(x, *args, **kw)

    cs.fused_conv_stack = recording
    counters.reset()
    res: dict = {"card": card}
    want_shapes = {(1, 64, 64)}
    try:
        be, be_url = backend(use_cache=True, weights=weights)
        fe = CacheFrontend(backend_url=f"{be_url}/upscale/image")
        fe_url = serve(fe.app)
        svc = be.get_pipeline()
        assert svc.device.type == "cuda" and svc.conv_stack == 1 and svc.coalesce_max == 8, (
            svc.device, svc.conv_stack, svc.coalesce_max)
        step_reset()
        # the service loads its weights on its worker thread: one small
        # request waits for that, so the timed requests below do not
        status, body = post_file(f"{be_url}/upscale/image", encode_image(make_frames(1, 64, 64, seed=50)[0], "PNG"))
        assert status == 200, body[:300]

        # (2) single requests, each checked for status, type and size
        frames_720 = make_frames(1, 720, 1280, seed=51)[0]
        rgb = make_frames(1, 375, 500, seed=52)[0]
        ramp = np.linspace(0, 255, rgb.shape[1], dtype=np.float32).astype(np.uint8)  # alpha: a ramp
        rgba = np.concatenate([rgb, np.broadcast_to(ramp[None, :, None], rgb.shape[:2] + (1,))], axis=-1)
        mono = make_frames(1, 480, 640, seed=53)[0].mean(-1).astype(np.uint8)
        cases = [
            ("1280x720 jpeg", encode_image(frames_720, "JPEG"), "image/jpeg", "RGB"),
            ("500x375 rgba png", encode_image(rgba, "PNG", "RGBA"), "image/png", "RGBA"),
            ("640x480 mono png", encode_image(mono, "PNG", "L"), "image/jpeg", "RGB"),
            ("1600x1200 jpeg", encode_image(make_frames(1, 1200, 1600, seed=54)[0], "JPEG"), "image/jpeg", "RGB"),
            ("4096x2048 jpeg (cap)", encode_image(make_frames(1, 2048, 4096, seed=55)[0], "JPEG"), "image/jpeg", "RGB"),
        ]
        rows = []
        for name, data, ctype, mode in cases:
            src = decode_image(data).size
            want_shapes.add((1, *request_sizes(*src)[0]))
            if name.endswith("(cap)"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            step_reset()
            t0 = time.perf_counter()
            status, reply = post_file(f"{be_url}/upscale/image", data, params={"return_type": "url"}, timeout=300)
            wall = (time.perf_counter() - t0) * 1e3
            launches = counters.read()
            assert status == 200, f"{name}: {status} {reply[:300]!r}"
            reply = json.loads(reply)
            assert reply["cache"] == "miss", reply
            body = get_bytes(f"{be_url}{reply['url']}")
            out = decode_image(body)
            want = expected_out_size(*src)
            assert out.size == want and out.mode == mode, f"{name}: {out.size} {out.mode}, expected {want} {mode}"
            assert {b"\xff\xd8": "image/jpeg"}.get(body[:2], "image/png") == ctype, f"{name}: not {ctype}"
            k4_only(launches, 32, name)
            # the backend's spans: read and decode the upload, the service
            # (queue, dispatch, device, copy back), then crop, post-scale,
            # alpha and encode
            spans = {k.split(".", 1)[1]: v * 1e3 for k, v in reply["profiler"].items()
                     if k in SPANS and isinstance(v, float) and v >= 0}
            row = {"request": name, "in_size": list(src), "out_size": list(out.size), "content_type": ctype,
                   "bytes_in": len(data), "bytes_out": len(body), "wall_ms": wall, "spans_ms": spans,
                   "k4_launches": launches["fused_conv_stack"]}
            if name.endswith("(cap)"):
                row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                row["request_mem_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
            rows.append(row)
            log(f"image service {name}: {src[0]}x{src[1]} -> {out.size[0]}x{out.size[1]} {ctype} "
                f"({len(body)} bytes), {wall:.3f} ms wall ("
                + ", ".join(f"{k} {v:.1f}" for k, v in spans.items())
                + f" ms), {launches['fused_conv_stack']} K4 launches"
                + (f", peak device memory {row['peak_mem_gb']:.2f} GB ({row['request_mem_gb']:.2f} GB above "
                   f"what was held before)" if "peak_mem_gb" in row else "") + f" on {card}")
        res["requests"] = rows

        # (3) card against the port on the CPU, float32, one small RGBA PNG
        def cpu_factory(on_queue):
            return EsrganUpscalerService(lr_level=3, denoising=False, batch_size=1, lr_hr_resize=False,
                                         output_shape=None, coalesce_max=8, weights=weights, device="cpu",
                                         compute_dtype=torch.float32, on_queue=on_queue)

        cpu_be, cpu_url = backend(upscaler_factory=cpu_factory)
        small = make_frames(1, 80, 96, seed=56)[0]
        small = np.concatenate([small, np.full(small.shape[:2] + (1,), 180, np.uint8)], axis=-1)
        data = encode_image(small, "PNG", "RGBA")
        got, want = (post_file(f"{u}/upscale/image", data, timeout=300) for u in (be_url, cpu_url))
        assert got[0] == want[0] == 200, (got[1][:300], want[1][:300])
        got, want = (np.asarray(decode_image(r[1])) for r in (got, want))
        assert got.shape == want.shape and got.shape[-1] == 4, (got.shape, want.shape)
        ref_std = float(want[..., :3].std() / 255)
        value = psnr(got[..., :3], want[..., :3])
        res["card_vs_cpu"] = {"size": [96, 80], "out_shape": list(got.shape), "psnr_db": value, "ref_std": ref_std,
                              "alpha_equal": bool((got[..., 3] == want[..., 3]).all())}
        log(f"image service, card bf16 vs the port's backend on the CPU in float32, 96x80 RGBA PNG -> "
            f"{got.shape[1]}x{got.shape[0]}: PSNR {value:.3f} dB (min {PSNR_MIN}), CPU output std {ref_std:.4f} "
            f"(min 0.05), alpha equal {res['card_vs_cpu']['alpha_equal']}")
        assert ref_std >= 0.05, f"the CPU output is near-constant (std {ref_std:.4f})"
        assert value >= PSNR_MIN, f"image service card vs CPU: PSNR {value:.3f} dB below {PSNR_MIN}"

        # (4) 8 concurrent requests of one bucket, against their lone runs
        n = 8
        blobs = [encode_image(f, "JPEG") for f in make_frames(n, 480, 640, seed=57)]
        dispatched = []
        orig = svc.upscale_dispatch

        def counting(frames):
            dispatched.append(len(frames))
            return orig(frames)

        svc.upscale_dispatch = counting
        gate = threading.Barrier(n, timeout=60)

        def post_together(blob):
            gate.wait()
            return post_file(f"{be_url}/upscale/image", blob, params={"return_type": "file"}, timeout=300)

        step_reset()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            together = list(pool.map(post_together, blobs))
        wall_together = time.perf_counter() - t0
        launches = counters.read()
        del svc.upscale_dispatch
        lone_be, lone_url = backend(use_cache=False, weights=weights)
        t0 = time.perf_counter()
        lone = [post_file(f"{lone_url}/upscale/image", b, timeout=300) for b in blobs]
        wall_lone = time.perf_counter() - t0
        assert all(r[0] == 200 for r in together + lone), [r[0] for r in together + lone]
        assert len(dispatched) < n and sum(dispatched) == n, f"the service did not coalesce: {dispatched}"
        k4_only(launches, 32 * len(dispatched), "concurrent requests")
        want_shapes.add((max(dispatched), *request_sizes(640, 480)[0]))
        worst = min(psnr(np.asarray(decode_image(a[1])), np.asarray(decode_image(b[1])))
                    for a, b in zip(together, lone))
        res["concurrent"] = {"requests": n, "size": [640, 480], "dispatches": list(dispatched),
                             "k4_launches": launches["fused_conv_stack"], "wall_s": wall_together,
                             "lone_wall_s": wall_lone, "min_psnr_db": worst}
        log(f"image service, {n} concurrent 640x480 JPEG requests: dispatches of {dispatched} "
            f"({launches['fused_conv_stack']} K4 launches), wall {wall_together:.3f} s against {wall_lone:.3f} s one "
            f"at a time; lowest PSNR against its lone run {worst:.3f} dB (min 45) on {card}")
        assert worst >= 45.0, f"a concurrent request is {worst:.3f} dB from its lone run"

        # (5) the frontend: a miss, then a hit that serves identical bytes
        data = encode_image(make_frames(1, 240, 320, seed=58)[0], "JPEG")
        stats0 = json.loads(get_bytes(f"{be_url}/upscale/stats"))
        step_reset()
        miss = post_file(f"{fe_url}/upscale/image", data, timeout=300)
        hit = post_file(f"{fe_url}/upscale/image", data, timeout=300)
        k4_only(counters.read(), 32, "frontend miss and hit")
        assert miss[0] == hit[0] == 200, (miss, hit)
        miss, hit = json.loads(miss[1]), json.loads(hit[1])
        assert (miss["cache"], hit["cache"]) == ("miss", "hit") and miss["url"] == hit["url"], (miss, hit)
        served = get_bytes(f"{fe_url}{hit['url']}")
        direct = post_file(f"{be_url}/upscale/image", data, params={"return_type": "file"}, timeout=300)
        assert direct[0] == 200 and served == direct[1], "the frontend's hit is not the backend's bytes"
        stats1 = json.loads(get_bytes(f"{be_url}/upscale/stats"))
        assert stats1["count"] - stats0["count"] == 2 and stats1["hitcount"] - stats0["hitcount"] == 1, (stats0, stats1)
        assert stats1["worker_alive"]
        res["frontend"] = {"miss": miss["cache"], "hit": hit["cache"], "bytes": len(served),
                           "backend_stats": stats1}
        log(f"image service frontend: miss then hit, {len(served)} identical bytes served; backend stats {stats1}")

        # (6) the load test through the frontend, 16 workers over 8 images:
        # each image's first request reaches the backend, every later one
        # is a hit in the frontend's memory cache (the host's hit path)
        images = [encode_image(f, "JPEG") for f in make_frames(8, 256, 256, seed=59)]
        url = f"{fe_url}/upscale/image"
        step_reset()
        cal = load_test.run(url, images, workers=16, rounds=1, requests_per_round=128)
        per_request = cal["seconds"] / cal["requests"]
        rounds = max(1, round((10.0 - cal["seconds"]) / (256 * per_request)))
        hits = load_test.run(url, images, workers=16, rounds=rounds, requests_per_round=256)
        launches = counters.read()
        for run in (cal, hits):
            run.pop("rounds")
            assert run["err"] == 0 and run["ok"] == run["requests"], f"load test errors: {run}"
        assert hits["hit"] == hits["requests"], f"the cache-hit rounds reached the backend: {hits}"
        # 8 misses, coalesced into 1 to 8 dispatches of 32 launches
        k4 = launches["fused_conv_stack"]
        assert k4 % 32 == 0 and 32 <= k4 <= 8 * 32, f"load test: K4 launches {k4}"
        k4_only(launches, k4, "load test")

        # misses only: 128 distinct images, none sent before, so every
        # request goes through the frontend to the backend and the card
        fresh = [encode_image(f, "JPEG") for k in range(16) for f in make_frames(8, 256, 256, seed=100 + k)]
        dispatched.clear()
        svc.upscale_dispatch = counting
        step_reset()
        misses = load_test.run(url, fresh, workers=16, rounds=1, requests_per_round=len(fresh), unique=True)
        miss_launches = counters.read()
        del svc.upscale_dispatch
        misses.pop("rounds")
        assert misses["err"] == 0 and misses["hit"] == 0 and misses["ok"] == len(fresh), f"misses run: {misses}"
        assert sum(dispatched) == len(fresh), f"misses run: dispatches {dispatched}"
        k4_only(miss_launches, 32 * len(dispatched), "misses run")
        misses["dispatches"] = len(dispatched)
        misses["max_coalesced"] = max(dispatched)
        misses["k4_launches"] = miss_launches["fused_conv_stack"]
        res["load_test"] = {"first_round_8_misses": cal, "frontend_hits": hits, "rounds": rounds,
                            "k4_launches": k4, "misses": misses}
        # the SR step's graphs: one a dispatch shape (bucket and coalesced
        # size) seen twice or more
        res["graphs"] = graph_counts(svc)
        log(f"image service's per-shape graphs after the load test: {res['graphs']}")
        for name, run in (("first round (8 misses, 120 frontend hits)", cal),
                          (f"{rounds} rounds of 256 frontend cache hits", hits),
                          (f"{len(fresh)} distinct images, misses only", misses)):
            log(f"load test through the frontend, {name}: {run['requests']} requests, {run['err']} errors, "
                f"{run['rps']:.1f} requests/s, p50 {run['p50_s'] * 1e3:.3f} ms, p99 {run['p99_s'] * 1e3:.3f} ms, "
                f"hit share {run['hit_share']:.4f} on {card}")
        log(f"misses run: {misses['dispatches']} dispatches (up to {misses['max_coalesced']} requests each), "
            f"{misses['k4_launches']} K4 launches")
        # K4 is held against its plain version below at the shapes above;
        # the sweep's small buckets add nothing to that
        known = set(k4_shapes)
        res["bucket_sweep"] = sweep_buckets(lone_be.get_pipeline(), lone_url, counters, card)
        k4_shapes &= known
    finally:
        cs.fused_conv_stack = k4_call
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for b in services:
            if b._upscaler is not None:
                b._upscaler.close()
    step_reset()
    res["k4_launches"] = k4_total[0]
    # K4 against its plain version at the shapes the image path gave it:
    # the 64x64 bucket, the cap's, a coalesced dispatch, and the others
    missing = want_shapes - k4_shapes
    assert not missing, f"the image path did not give K4 {sorted(missing)}; it gave {sorted(k4_shapes)}"
    res["k4_shapes"] = check_k4_at_image_shapes(bench_cs, sorted(k4_shapes), card)
    counters.reset()
    res["backend_cli"] = run_backend_cli(card)
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def sweep_buckets(svc, url: str, counters, card: str, extra: int = 4) -> dict:
    """Phase 11's bucket sweep: through a backend without a result cache,
    two distinct 64-pixel-high images for each of MAX_GRAPHS + `extra`
    widths (each its own bucket), one at a time, twice over.  The SR
    step captures the first MAX_GRAPHS signatures that recur and runs the
    rest eagerly, so the second sweep must add no graph and no device
    memory: what the graphs hold stays bounded however many buckets the
    traffic brings."""
    from sharkshark_tpu_torch.image_server.http_util import post_file
    from sharkshark_tpu_torch.upscale.jit_cache import MAX_GRAPHS

    cache = svc._multi_step
    widths = [64 * k for k in range(1, MAX_GRAPHS + extra + 1)]
    buckets = {request_sizes(w, 64)[0] for w in widths}
    assert len(buckets) == len(widths), f"the widths share buckets: {sorted(buckets)}"
    torch.cuda.synchronize()
    rows = [{"graphs": cache.num_graphs, "signatures": cache.num_signatures,
             "allocated_gb": torch.cuda.memory_allocated() / 1e9, "reserved_gb": torch.cuda.memory_reserved() / 1e9}]
    k4 = counters.read()["fused_conv_stack"]
    for sweep in range(2):
        for w in widths:
            for seed in range(2):
                data = encode_image(make_frames(1, 64, w, seed=400 + 2 * w + seed)[0], "PNG")
                status, body = post_file(f"{url}/upscale/image", data, timeout=300)
                assert status == 200, body[:300]
        torch.cuda.synchronize()
        rows.append({"graphs": cache.num_graphs, "signatures": cache.num_signatures,
                     "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                     "reserved_gb": torch.cuda.memory_reserved() / 1e9})
    k4 = counters.read()["fused_conv_stack"] - k4
    assert k4 == 32 * 4 * len(widths), f"bucket sweep: {k4} K4 launches"
    assert rows[1]["graphs"] == rows[2]["graphs"] == MAX_GRAPHS, rows
    grown = rows[2]["allocated_gb"] - rows[1]["allocated_gb"]
    assert grown <= 0.016, f"the second sweep grew the memory held by {grown:.4f} GB: {rows}"

    def trail(key: str, fmt: str = "{}") -> str:
        return " -> ".join(fmt.format(r[key]) for r in rows)

    log(f"image service bucket sweep, {len(widths)} buckets x 2 images, twice: graphs held {trail('graphs')} "
        f"(cap {MAX_GRAPHS}), signatures {trail('signatures')}, device memory allocated "
        f"{trail('allocated_gb', '{:.4f}')} GB, reserved {trail('reserved_gb', '{:.4f}')} GB on {card}")
    return {"widths": widths, "cap": MAX_GRAPHS, "readings": rows, "k4_launches": k4}


def run_backend_cli(card: str) -> dict:
    """The backend as a user starts it, `python -m
    sharkshark_tpu_torch.image_server.backend --use-cache --weights ...`
    on a free loopback port (its main resolves the card and builds K4
    before serving): the time until it answers a ping, then one upload
    (a miss) and the same again (a hit)."""
    import socket

    from sharkshark_tpu_torch.image_server.http_util import post_file

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen([sys.executable, "-m", "sharkshark_tpu_torch.image_server.backend", "--host", "127.0.0.1",
                             "--port", str(port), "--use-cache", "--weights", str(MINTED / "srvgg-derived-x4.pth")],
                            cwd=ROOT)
    try:
        t0 = time.perf_counter()
        while True:
            try:
                assert get_bytes(f"{url}/upscale/ping") == b"pong"
                break
            except OSError:
                assert proc.poll() is None, f"the backend CLI exited with {proc.returncode}"
                assert time.perf_counter() - t0 < 120, "the backend CLI did not answer within 120 s"
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        data = encode_image(make_frames(1, 200, 300, seed=60)[0], "JPEG")
        walls, caches = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            status, reply = post_file(f"{url}/upscale/image", data, params={"return_type": "url"}, timeout=300)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert status == 200, reply[:300]
            caches.append(json.loads(reply)["cache"])
        assert caches == ["miss", "hit"], caches
        out = decode_image(get_bytes(f"{url}/upscale/file/{json.loads(reply)['url'].rsplit('/', 1)[1]}"))
        assert out.size == expected_out_size(300, 200), out.size
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    log(f"backend CLI: answered a ping {up_s:.3f} s after its start; a 300x200 upload {walls[0]:.3f} ms (miss), "
        f"{walls[1]:.3f} ms (hit) on {card}")
    return {"up_s": up_s, "miss_ms": walls[0], "hit_ms": walls[1]}


# -------------------------------------------------------------- phase 12

# the three recipes the training driver ports, by generator name, with
# their configs and the minted weights test mode loads
TRAIN_RECIPES = {
    "frnet": ("egvsr_derived.yml", "egvsr-derived-x4.pth"),
    "srvgg": ("srvgg_derived.yml", "srvgg-derived-x4.pth"),
    "bsvd": ("bsvd_derived.yml", "bsvd-derived-32.pth"),
}
TRAIN_ITERS, TRAIN_CKPT_FREQ = 30, 10


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 setting for the block (PyTorch's default is on; the
    card-against-CPU checks turn it off)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def write_training_data(tmp: Path) -> dict[str, Path]:
    """The derived datasets of the three configs, from five seeded
    textured 640x640 stills (still_000 held out for val), through the
    port's tools/make_derived_dataset.py: 12 GT crops of 256 px in panned
    sequences, LR = bicubic /4; T = 4 for FRNet and SRVGG (val: one
    4-frame sequence), T = 8 for BSVD (val: one 8-frame sequence and its
    copy with sigma-25 noise)."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    mdd.write_stills(str(tmp / "stills"), 5, 640, seed=12)
    common = ["--src", str(tmp / "stills"), "--holdout", "still_000.png", "--seqs", "12", "--crop", "256",
              "--scale", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        mdd.main(common + ["--out", str(tmp / "derived"), "--tempo", "4", "--val-tempo", "4"])
        mdd.main(common + ["--out", str(tmp / "derived_t8"), "--tempo", "8", "--val-tempo", "8",
                           "--noisy-sigma", "25"])
    # the configs' data paths -> these; the longer prefix is replaced first
    return {"/tmp/ss4_derived_t8": tmp / "derived_t8", "/tmp/ss4_derived": tmp / "derived"}


def training_config(driver, name: str, data: dict[str, Path], tmp: Path) -> dict:
    """The recipe's config as committed (widths, crops, batch, T, rates),
    with its data and checkpoint directories moved into `tmp`, 30
    iterations, a checkpoint every 10, and no periodic test."""
    opt = driver.load_config(str(ROOT / "configs" / TRAIN_RECIPES[name][0]))
    for split in ("train", "test"):
        for key in ("gt_seq_dir", "lr_seq_dir"):
            path = opt["dataset"][split][key]
            for old, new in data.items():
                path = path.replace(old, str(new))
            opt["dataset"][split][key] = path
    opt["train"].update(total_iter=TRAIN_ITERS, ckpt_freq=TRAIN_CKPT_FREQ, ckpt_dir=str(tmp / f"ckpt_{name}"))
    opt["logger"]["log_freq"] = TRAIN_CKPT_FREQ
    opt["test"]["test_freq"] = 0
    return opt


def write_config(opt: dict, path: Path) -> str:
    import yaml

    path.write_text(yaml.safe_dump(opt))
    return str(path)


def leaf_rel_errs(got: list, want: list) -> list[float]:
    return [float((a.detach().cpu().double() - b.detach().cpu().double()).norm()
                  / b.detach().cpu().double().norm().clamp(min=1e-30)) for a, b in zip(got, want)]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """Paths of a parameter tree's leaves, in param_leaves order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def check_train_step_against_cpu(driver, opt: dict, batch: dict) -> dict:
    """One step's loss and every gradient leaf, on the card (TF32 off)
    against the CPU, on the same seeded weights and the driver's first
    batch (for BSVD the same noisy clip).  A leaf must lie within 1e-3 of
    the CPU's, or within twice its own float32 floor where that is
    higher: the CPU's float32 gradient against the same step in float64
    (the warp samples in float32 either way), taken only when a leaf
    passes 1e-3.  FRNet's leaves, whose gradients at the seeded init sum
    large terms of both signs, sit near 1e-3 in float32 on any device."""
    from sharkshark_tpu_torch.train import denoise, vsr

    def double(tree):
        if isinstance(tree, dict):
            return {k: double(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [double(v) for v in tree]
        return tree.detach().double().requires_grad_(True)

    def step(dev, dtype):
        recipe = driver.build_training(opt, dev)
        gt = torch.from_numpy(batch["gt"])
        if isinstance(recipe.cfg, denoise.DenoiseTrainConfig):
            x = denoise.noisy_input(recipe.cfg, gt, 0)[0]
        else:
            x = torch.from_numpy(batch["lr"])
        params = recipe.state.params if dtype == torch.float32 else double(recipe.state.params)
        leaves = vsr.param_leaves(params)
        loss, _ = recipe.loss_fn(params, x.to(leaves[0].device, dtype), gt.to(leaves[0].device, dtype))
        return float(loss.detach()), torch.autograd.grad(loss, leaves), leaf_names(params)

    cpu, card = step("cpu", torch.float32), step("cuda", torch.float32)
    rel = leaf_rel_errs(card[1], cpu[1])
    floor = leaf_rel_errs(cpu[1], step("cpu", torch.float64)[1]) if max(rel) > 1e-3 else [None] * len(rel)
    names = cpu[2]
    worst = sorted(range(len(rel)), key=lambda i: -rel[i])[:3]
    flat = [torch.cat([g.detach().cpu().double().flatten() for g in grads]) for grads in (card[1], cpu[1])]
    return {"loss_cpu": cpu[0], "loss_card": card[0], "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
            "grad_rel_err_max": max(rel), "grad_leaves": len(rel),
            "grad_rel_err_all": float((flat[0] - flat[1]).norm() / flat[1].norm()),
            "worst_leaves": [[names[i], rel[i], floor[i]] for i in worst],
            "leaves_over_bound": [names[i] for i in range(len(rel))
                                  if rel[i] > 1e-3 and not rel[i] <= 2 * floor[i]]}


TF32_PEAK_FLOPS = 495e12  # H100 SXM dense TF32, NVIDIA's data sheet


def time_train_step(driver, opt: dict, batch: dict, warmup: int = 3, iters: int = 10, recipes=None,
                    routes=("eager", "graphs")) -> dict:
    """ms per training iteration on one batch already on the card, for
    each of `routes`: "eager", the recipe's plain step (`step.eager`), and
    "graphs", the driver's compiled step (its CUDA graph replayed), each
    on a recipe of its own (`recipes`: the config's fresh ones unless
    given), within one call in passes eager, graphs, graphs, eager of
    iters / 2 iterations, after `warmup` calls (the graph's warm-up,
    capture and a replay among them).  Each iteration synchronised: its
    step ms, and the host ms until the call returned (on an idle device:
    the eager step's host work, the replay's prologue, copies and
    launch); medians.  Memory: the eager step's peak above the state's;
    for the graphs, the peak of the warm-up and capture above the
    state's, and the memory the graph's pool holds after them.  The
    step's conv and matmul FLOPs (forward and backward, FlopCounterMode,
    on the first call, which runs eagerly either way) and its bound at
    the TF32 peak, which cuDNN's convs use at PyTorch's default."""
    from torch.utils.flop_counter import FlopCounterMode

    recipes = recipes or {r: driver.build_training(opt, "cuda") for r in routes}
    lr = torch.from_numpy(batch["lr"]).cuda()
    gt = torch.from_numpy(batch["gt"]).cuda()
    calls = {r: (lambda rc=recipes[r], r=r: (rc.step.eager if r == "eager" else rc.step)(rc.state, lr, gt))
             for r in routes}
    counter = FlopCounterMode(display=False)
    with counter:
        calls[routes[0]]()
    flops = float(counter.get_total_flops())
    res = {"gflop": flops / 1e9, "bound_ms_tf32": flops / TF32_PEAK_FLOPS * 1e3}
    for r in routes:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        for _ in range(warmup - (r == routes[0])):
            calls[r]()
        torch.cuda.synchronize()
        if r == "graphs":
            torch.cuda.empty_cache()
            res["graphs"] = {"warm_capture_peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                             "pool_gb": (torch.cuda.memory_reserved() - reserved) / 1e9,
                             "graphs": recipes[r].step.num_graphs}
    times, host, peak = ({r: [] for r in routes} for _ in range(3))
    for r in (list(routes) + list(routes)[::-1]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for _ in range(max(iters // 2, 1)):
            t0 = time.perf_counter()
            calls[r]()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times[r].append((time.perf_counter() - t0) * 1e3)
            host[r].append((t1 - t0) * 1e3)
        peak[r].append((torch.cuda.max_memory_allocated() - held) / 1e9)
    for r in routes:
        res.setdefault(r, {}).update(
            ms_per_iter=statistics.median(times[r]), ms_min=min(times[r]), ms_max=max(times[r]),
            host_ms=statistics.median(host[r]), peak_gb=max(peak[r]), times_ms=times[r])
        res[r]["tflops_per_s"] = flops / res[r]["ms_per_iter"] / 1e9
    if "eager" in res and "graphs" in res:
        res["eager_over_graphs"] = res["eager"]["ms_per_iter"] / res["graphs"]["ms_per_iter"]
        res["pool_over_eager_peak"] = res["graphs"]["pool_gb"] / res["eager"]["peak_gb"]
    return res


def train_timing_text(t: dict) -> str:
    """One line of time_train_step's numbers."""
    out = []
    for r in ("eager", "graphs"):
        if r in t:
            out.append(f"{r} {t[r]['ms_per_iter']:.3f} ms ({t[r]['ms_min']:.3f}-{t[r]['ms_max']:.3f}), host "
                       f"{t[r]['host_ms']:.3f} ms a call")
    text = "; ".join(out) + f"; {t['gflop']:.3f} GFLOP, bound {t['bound_ms_tf32']:.3f} ms at the TF32 peak"
    if "eager" in t:
        text += f"; eager peak {t['eager']['peak_gb']:.3f} GB above the state"
    if "graphs" in t:
        g = t["graphs"]
        text += (f"; graphs {g['graphs']}, pool {g['pool_gb']:.3f} GB, warm-up and capture peak "
                 f"{g['warm_capture_peak_gb']:.3f} GB")
    if "eager_over_graphs" in t:
        text += f"; eager / graphs {t['eager_over_graphs']:.2f}x, pool / eager peak {t['pool_over_eager_peak']:.2f}x"
    return text


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic implementations for the block (cuDNN's
    deterministic convs, a sorted scatter for the warp's gather
    backward)."""
    old = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old[1:]


def state_leaves(state) -> list:
    """Every parameter tensor of a train state (a TrainState's params; a
    GAN state's params_g and params_d)."""
    from sharkshark_tpu_torch.train import vsr

    return [t for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), dict)
            for t in vsr.param_leaves(getattr(state, f.name))]


def check_resume_on_card(driver, opt: dict, batches: list, tmp: Path) -> dict:
    """Four steps straight against two, a checkpoint, a fresh state
    restored from it and two more, on four of the driver's (lr, gt)
    batches on the card, every parameter of the state compared (both
    networks' for the GAN).  With deterministic algorithms the two must
    agree bit for bit.  With PyTorch's defaults cuDNN's weight gradients
    and the warp's gather backward add in a nondeterministic order, so
    there the distance between the resumed and a straight run's
    parameters, over the distance the straight run moved them, is
    reported beside the same measure between two straight runs."""
    from sharkshark_tpu_torch.train import checkpoint

    def params(steps: int, resume_at: int | None = None):
        recipe = driver.build_training(opt, "cuda")
        init = torch.cat([t.detach().flatten() for t in state_leaves(recipe.state)])
        state = recipe.state
        for i, (lr, gt) in enumerate(batches[:steps]):
            if i == resume_at:
                path = checkpoint.save_checkpoint(str(tmp / "resume"), state, state.step)
                state = checkpoint.load_checkpoint(path, driver.build_training(opt, "cuda").state)
            state, _ = recipe.step(state, lr, gt)
        assert state.step == steps
        return init, torch.cat([t.detach().flatten() for t in state_leaves(state)])

    def rel(a, b, init):
        return float((a - b).norm() / (b - init).norm())

    init, straight = params(4)
    _, again = params(4)
    _, resumed = params(4, resume_at=2)
    res = {"default_straight_vs_straight": rel(again, straight, init),
           "default_resumed_vs_straight": rel(resumed, straight, init)}
    with deterministic_algorithms():
        _, straight = params(4)
        _, resumed = params(4, resume_at=2)
    res["deterministic_bit_identical"] = bool(torch.equal(resumed, straight))
    return res


def plain_adam(recipe):
    """The recipe's state with torch.optim's plain Adam (float rates, its
    bias correction in float64 on the host, its state made at the first
    update) in place of the card's capturable one: eager only."""
    from sharkshark_tpu_torch.train import vsr

    state = recipe.state
    for name in ("opt", "opt_g", "opt_d"):
        if hasattr(state, name):
            old = getattr(state, name)
            g = old.param_groups[0]
            setattr(state, name, torch.optim.Adam(g["params"], lr=float(g["lr"]), betas=g["betas"], eps=g["eps"]))
            assert not getattr(state, name).param_groups[0]["capturable"]
    return recipe


def state_snapshot(state) -> list:
    """Copies of every tensor the step reads or writes: parameters, Adam's
    moments, counts and rates, and the GAN's D count."""
    from sharkshark_tpu_torch.train import compiled

    return [t.detach().clone() for t in compiled.state_tensors(state)]


def check_graphs_on_card(driver, opt: dict, batches: list) -> dict:
    """The driver's compiled step (its CUDA graph) against the recipe's
    eager step, from the config's seeded state on six of the driver's
    batches: under deterministic algorithms identical bit for bit at every
    step (warm-up, capture, four replays: every log, the GAN's D loss,
    which is 0 where D was skipped, among them), then every tensor of the
    state and the step; with PyTorch's defaults (cuDNN's weight gradients
    add in a nondeterministic order) the graphed run's distance from an
    eager one, over the distance the eager run moved the parameters,
    beside the same measure between two eager runs."""

    def run(route):
        recipe = driver.build_training(opt, "cuda")
        state = recipe.state
        init = torch.cat([t.detach().flatten() for t in state_leaves(state)])
        fn = recipe.step if route == "graphs" else recipe.step.eager
        logs = [fn(state, lr, gt)[1] for lr, gt in batches]
        torch.cuda.synchronize()
        out = {"init": init, "params": torch.cat([t.detach().flatten() for t in state_leaves(state)]),
               "logs": logs, "snap": state_snapshot(state), "step": state.step}
        if route == "graphs":
            out["graphs"] = {"signatures": recipe.step.num_signatures, "graphs": recipe.step.num_graphs}
        return out

    def rel(a, b):
        return float((a["params"] - b["params"]).norm() / (b["params"] - b["init"]).norm())

    with deterministic_algorithms():
        eager, graphs = run("eager"), run("graphs")
    res = {"steps": len(batches), "graphs": graphs["graphs"], "deterministic_bit_identical": (
        all(torch.equal(a[key], b[key]) for a, b in zip(eager["logs"], graphs["logs"]) for key in a)
        and eager["step"] == graphs["step"] and all(torch.equal(a, b) for a, b in zip(eager["snap"], graphs["snap"])))}
    if "l_gan_D" in eager["logs"][0]:
        res["d_updates"] = [bool(x["l_gan_D"] != 0) for x in eager["logs"]]
    e1, e2, g = run("eager"), run("eager"), run("graphs")
    res["default_eager_vs_eager"], res["default_graphs_vs_eager"] = rel(e2, e1), rel(g, e1)
    return res


def check_capturable_adam(driver, opt: dict, steps: int = 30) -> dict:
    """The card's capturable Adam (vsr.make_optimizer: its bias correction
    in float32 on the device, a tensor rate) against torch.optim's plain
    Adam (in float64 on the host, a float rate) over `steps` updates of
    copies of the recipe's seeded parameters (both networks' for the
    GAN) on identical seeded gradients, at the config's rate decayed by
    0.9 a step: the distance between the two, over the distance the plain
    one moved them, and the largest difference.  (Whole training runs of
    the two part much further: the step's own float32 rounding grows
    through FRNet's recurrence, as cuDNN's nondeterministic sums do.)"""
    from sharkshark_tpu_torch.train import vsr

    recipe = driver.build_training(opt, "cuda")
    leaves = state_leaves(recipe.state)
    rate = float(getattr(recipe.cfg, "lr", getattr(recipe.cfg, "lr_g", 1e-4)))
    a = [p.detach().clone().requires_grad_(True) for p in leaves]
    b = [p.detach().clone().requires_grad_(True) for p in leaves]
    init = torch.cat([p.detach().flatten() for p in leaves])
    cap = vsr.make_optimizer(a, rate, 0.9, 0.999)
    plain = torch.optim.Adam(b, lr=rate, betas=(0.9, 0.999), eps=1e-8)
    assert cap.param_groups[0]["capturable"] and not plain.param_groups[0]["capturable"]
    gen = torch.Generator(device="cuda").manual_seed(20)
    for k in range(steps):
        for x, y in zip(a, b):
            x.grad = torch.randn(x.shape, generator=gen, device="cuda") * 1e-2
            y.grad = x.grad.clone()
        vsr.set_rate(cap, rate * 0.9**k)
        vsr.set_rate(plain, rate * 0.9**k)
        cap.step()
        plain.step()
    fa, fb = (torch.cat([p.detach().flatten() for p in x]) for x in (a, b))
    return {"steps": steps, "leaves": len(leaves), "rel": float((fa - fb).norm() / (fb - init).norm()),
            "max_abs": float((fa - fb).abs().max())}


def loader_batches(driver, opt: dict, n: int = 4) -> list:
    """The first n of the driver's training batches as (lr, gt) on the
    card, BD-degraded there where the config says so."""
    degrade = driver.make_degrade(opt, "cuda")
    batches = []
    while len(batches) < n:  # the loader may hold fewer than n batches an epoch
        for b in driver.train_loader(opt):
            gt = torch.from_numpy(b["gt"]).cuda()
            d = degrade(gt) if degrade else {"lr": torch.from_numpy(b["lr"]).cuda(), "gt": gt}
            batches.append((d["lr"], d["gt"]))
    return batches[:n]


def run_training_recipe(driver, counters, name: str, data: dict, tmp: Path, card: str) -> dict:
    """One recipe through the driver: train 30 iterations (checkpoints at
    10, 20, 30; FRNet with a periodic test at each) and resume from the
    20th, as a user runs them, each step through its CUDA graph; the step
    timed eager and through its graph; the graph held against the eager
    step, the capturable Adam against the plain one; the resume on the
    card; one step against the CPU; test mode with the minted weights on
    the card (FRNet's also on the CPU); profile."""
    res = {}
    opt = training_config(driver, name, data, tmp)
    if name == "frnet":
        # a periodic test at each checkpoint: its inference warms up,
        # captures and replays, K3 once a frame each time
        opt["test"]["test_freq"] = TRAIN_CKPT_FREQ
    val_frames = sum(sample["lr"].shape[0] for sample in driver._make_dataset(opt, "test"))
    cfg_path = write_config(opt, tmp / f"{name}.yml")
    with cudnn_tf32(True):
        counters.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = driver.main(["--config", cfg_path, "--mode", "train"])
        res["train_wall_s"] = time.perf_counter() - t0
        res["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["train_launches"] = counters.read()
        losses, k = run["losses"], TRAIN_CKPT_FREQ
        assert run["iter"] == TRAIN_ITERS and len(losses) == TRAIN_ITERS, run["iter"]
        assert all(np.isfinite(losses)), losses
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        assert last < first, f"{name}: the mean loss of the last {k} iterations {last} is not below the first's {first}"
        want = [f"ckpt_{i:09d}" for i in range(k, TRAIN_ITERS + 1, k)]
        assert [Path(p).name for p in run["checkpoints"]] == want, run["checkpoints"]
        # a signature a batch shape (SRVGG's epoch of 12 clips at batch 8
        # ends in a partial batch of 4), each captured at its second call
        shapes = len({b["gt"].shape for b in driver.train_loader(opt)})
        res["step_graphs"], res["test_graphs"] = run["step_graphs"], run["test_graphs"]
        assert run["step_graphs"] == {"signatures": shapes, "graphs": shapes}, (run["step_graphs"], shapes)
        # the training step runs no kernel: K3 has no backward
        # (forward_sequence warps with the plain gather) and BSVD's shift
        # convs take the library route in float32; FRNet's periodic tests
        # launch K3 once a frame, through their graph from the second on
        tests = len(run["tests"])
        want_launches = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": tests * val_frames, "fused_conv_stack": 0}
        assert res["train_launches"] == want_launches, (res["train_launches"], want_launches)
        if name == "frnet":
            assert tests == TRAIN_ITERS // k and run["test_graphs"] == {"signatures": 1, "graphs": 1}, run
            res["periodic_tests"] = run["tests"]
        res.update(losses=losses, loss_first10=first, loss_last10=last)
        os.remove(run["checkpoints"][-1])
        rerun = driver.main(["--config", cfg_path, "--mode", "train"])
        assert Path(rerun["resumed_from"]).name == want[-2], rerun["resumed_from"]
        assert rerun["iter"] == TRAIN_ITERS and len(rerun["losses"]) == k
        assert all(np.isfinite(rerun["losses"])), rerun["losses"]
        res["resumed_losses"] = rerun["losses"]
        loader = driver.train_loader(opt)
        batch = next(iter(loader))
        res["timing"] = time_train_step(driver, opt, batch)
        batches = loader_batches(driver, opt, 6)
        res["graphs_vs_eager"] = gve = check_graphs_on_card(driver, opt, batches)
        assert gve["deterministic_bit_identical"] and gve["graphs"] == {"signatures": shapes, "graphs": shapes}, gve
        res["capturable_adam"] = check_capturable_adam(driver, opt)
        assert res["capturable_adam"]["rel"] <= 1e-4, res["capturable_adam"]
        res["resume"] = check_resume_on_card(driver, opt, batches[:4], tmp / name)
        assert res["resume"]["deterministic_bit_identical"], res["resume"]
    with cudnn_tf32(False):
        res["card_vs_cpu"] = check_train_step_against_cpu(driver, opt, batch)
        cmp = res["card_vs_cpu"]
        assert cmp["loss_rel_err"] <= 1e-4 and not cmp["leaves_over_bound"], cmp
        # test mode, minted weights: the card (through main) and the CPU
        topt = {**opt, "model": {**opt["model"], "generator": {
            **opt["model"]["generator"], "load_path": str(MINTED / TRAIN_RECIPES[name][1])}}}
        topt["test"] = {**opt["test"], "res_dir": str(tmp / f"res_{name}_card")}
        test_path = write_config(topt, tmp / f"{name}_test.yml")
        counters.reset()
        t0 = time.perf_counter()
        card_res = driver.main(["--config", test_path, "--mode", "test"])["test"]
        res["test_wall_s"] = time.perf_counter() - t0
        res["test_launches"] = counters.read()
        card_frames = sorted((tmp / f"res_{name}_card").rglob("*.png"))
        res["test"] = {"psnr_card": card_res["PSNR"], "frames": len(card_frames),
                       "ms_per_frame": res["test_wall_s"] * 1e3 / len(card_frames)}
        k3 = res["test_launches"]["backward_warp"]
        assert k3 == (len(card_frames) if name == "frnet" else 0), res["test_launches"]
        if name == "frnet":
            # K3's path, held against the CPU's plain warp
            topt["test"]["res_dir"] = str(tmp / f"res_{name}_cpu")
            res["test"]["psnr_cpu"] = driver.test(topt, device="cpu")["test"]["PSNR"]
            res["test"]["frame_psnr_card_vs_cpu_db"] = [
                psnr(np.asarray(_png(f)), np.asarray(_png(tmp / f"res_{name}_cpu" / f.relative_to(
                    tmp / f"res_{name}_card")))) for f in card_frames]
            assert abs(card_res["PSNR"] - res["test"]["psnr_cpu"]) <= 0.05, res["test"]
            assert min(res["test"]["frame_psnr_card_vs_cpu_db"]) >= 45.0, res["test"]
    with cudnn_tf32(True):
        res["profile"] = driver.main(["--config", cfg_path, "--mode", "profile"])
    periodic = ""
    if name == "frnet":
        periodic = (f"; periodic tests at {list(run['tests'])} through one inference graph "
                    f"({run['test_graphs']}), K3 {res['train_launches']['backward_warp']} = {tests} x {val_frames} "
                    f"frames, PSNR {[round(v['test']['PSNR'], 4) for v in run['tests'].values()]}")
    log(f"training {name} ({TRAIN_RECIPES[name][0]}) on {card}: {TRAIN_ITERS} iterations in "
        f"{res['train_wall_s']:.3f} s through the step's graphs ({run['step_graphs']}), loss {first:.1f} -> "
        f"{last:.1f} (mean of the first / last {k}), peak {res['train_peak_gb']:.3f} GB{periodic}; step "
        f"{train_timing_text(res['timing'])}; graphs against eager {gve}; capturable Adam against the plain one "
        f"{res['capturable_adam']}; resumed from {TRAIN_ITERS - k}: {k} more; "
        f"resume on the card {res['resume']}; card vs CPU loss {cmp['loss_rel_err']:.2e}, "
        f"grads {cmp['grad_rel_err_all']:.2e} (all), {cmp['grad_rel_err_max']:.2e} (max of {cmp['grad_leaves']} leaves; the worst [leaf, card vs CPU, "
        f"CPU float32 vs float64]: {cmp['worst_leaves']}); test PSNR "
        f"{card_res['PSNR']:.4f} dB ({res['test']}), K3 {k3}; profile {res['profile']['flops'] / 1e9:.3f} "
        f"GFLOP a call, {res['profile']['params']} params, {res['profile']['fps']:.2f} calls/s (replayed)")
    return res


def _png(path: Path):
    from PIL import Image

    return Image.open(path).convert("RGB")


def run_training_phase(counters, card: str, tmp: Path) -> dict:
    """Phase 12: the FRNet, SRVGG and BSVD recipes through the training
    driver on the card, at their configs' widths, in `tmp`."""
    from sharkshark_tpu_torch.train import driver

    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    data = write_training_data(tmp)
    res["data_s"] = time.perf_counter() - t0
    for name in TRAIN_RECIPES:
        res[name] = run_training_recipe(driver, counters, name, data, tmp, card)
    res["wall_s"] = time.perf_counter() - t_phase
    return res


# -------------------------------------------------------------- phase 13

GAN_ITERS, GAN_CKPT_FREQ, GAN_TEMPO = 30, 10, 10
GAN_CUTS = [
    f"{GAN_ITERS} iterations, against the config's 500000",
    f"a checkpoint every {GAN_CKPT_FREQ}, against 5000",
    "a Folder dataset (phase 12's derived set at T 10: 12 sequences from five seeded 640x640 stills) in place of "
    "VimeoTecoGAN LMDB and Vid4: neither is in the repository, and lmdb is absent on the card machine",
]
# the variants at their default configs (the reference's Y-channel models)
VARIANT_LR = (180, 320)


def write_gan_data(tmp: Path) -> Path:
    """Phase 12's derived set (from its stills) at T = 10: 12 panned
    sequences of 256-px GT crops and a 10-frame val sequence."""
    from sharkshark_tpu_torch.tools import make_derived_dataset as mdd

    with contextlib.redirect_stdout(io.StringIO()):
        mdd.main(["--src", str(tmp / "stills"), "--holdout", "still_000.png", "--seqs", "12", "--crop", "256",
                  "--scale", "4", "--out", str(tmp / "derived_t10"), "--tempo", str(GAN_TEMPO),
                  "--val-tempo", str(GAN_TEMPO)])
    return tmp / "derived_t10"


def gan_config(driver, data: Path, tmp: Path, name: str = "gan") -> dict:
    """configs/tecogan_bd.yml as committed (FRNet nf 64 / nb 10, the
    spatio-temporal D, GT crop 128, batch 4, T 10, BD sigma 1.5, the five
    losses, rates 5e-5), with GAN_CUTS."""
    opt = driver.load_config(str(ROOT / "configs" / "tecogan_bd.yml"))
    opt["dataset"]["train"].update(name="Folder", gt_seq_dir=str(data / "train" / "GT"),
                                   lr_seq_dir=str(data / "train" / "LR"))
    opt["dataset"]["test1"].update(name="Folder", gt_seq_dir=str(data / "val" / "GT"),
                                   lr_seq_dir=str(data / "val" / "LR"))
    opt["train"].update(total_iter=GAN_ITERS, ckpt_freq=GAN_CKPT_FREQ, ckpt_dir=str(tmp / f"ckpt_{name}"))
    opt["logger"]["log_freq"] = GAN_CKPT_FREQ
    opt["test"].update(test_freq=0, json_dir=str(tmp / f"json_{name}"))
    return opt


def gan_grads(driver, opt: dict, lr: torch.Tensor, gt: torch.Tensor, dev: str, dtype) -> dict:
    """The GAN step's D loss and G loss with every gradient leaf (D's
    unused biases left out), its logs and its D decision, on `dev` in
    `dtype`, from the config's seeded weights."""
    from sharkshark_tpu_torch.train import vsr

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cast(v) for v in tree]
        return tree.detach().to(dtype).requires_grad_(True)

    recipe = driver.build_training(opt, dev)
    pg, pd, losses = cast(recipe.state.params_g), cast(recipe.state.params_d), recipe.loss_fn
    ctx = losses.prepare(pg, lr.to(dev, dtype), gt.to(dev, dtype))
    loss_d, aux = losses.d_loss(pd, ctx)
    g_d = torch.autograd.grad(loss_d, vsr.param_leaves(pd), allow_unused=True)
    loss_g, logs = losses.g_loss(pg, pd, ctx, aux)
    g_g = torch.autograd.grad(loss_g, vsr.param_leaves(pg), allow_unused=True)
    names = [f"D{n}" for n, g in zip(leaf_names(pd), g_d) if g is not None] + [f"G{n}" for n in leaf_names(pg)]
    return {"loss_d": float(loss_d.detach()), "logs": {k: float(v.detach()) for k, v in logs.items()},
            "upd_d": bool(aux["distance"] < recipe.cfg.update_threshold), "distance": float(aux["distance"]),
            "grads_d": [g for g in g_d if g is not None], "grads_g": list(g_g), "names": names}


def check_gan_step_against_cpu(driver, opt: dict, lr: torch.Tensor, gt: torch.Tensor) -> dict:
    """One GAN step's every loss, the D decision and both networks' whole
    gradient and leaves, on the card (TF32 off) against the CPU, from the
    same seeded weights on the first sample of the driver's first
    (degraded) batch.  Held in float64 (losses within 1e-6, every leaf
    within 1e-5, the same D decision): the seeded FRNet's 19-frame
    recurrence grows its output by orders of magnitude a frame, so in
    float32 the CPU itself lies far from float64 (its "floor", reported
    beside the card's float32 leaves, which are reported, not held)."""
    lr, gt = lr[:1], gt[:1]
    runs = {(d, t): gan_grads(driver, opt, lr, gt, d, t) for d in ("cpu", "cuda") for t in (torch.float64,
                                                                                           torch.float32)}
    ref, card = runs["cpu", torch.float64], runs["cuda", torch.float64]

    def leaves(r):
        return r["grads_d"] + r["grads_g"]

    def whole(a, b):
        fa, fb = (torch.cat([g.detach().cpu().double().flatten() for g in x]) for x in (a, b))
        return float((fa - fb).norm() / fb.norm())

    def loss_errs(a, b):
        errs = {k: abs(a["logs"][k] - v) / max(abs(v), 1e-30) for k, v in b["logs"].items()}
        errs["l_D"] = abs(a["loss_d"] - b["loss_d"]) / abs(b["loss_d"])
        return errs

    rel64 = leaf_rel_errs(leaves(card), leaves(ref))
    rel32 = leaf_rel_errs(leaves(runs["cuda", torch.float32]), leaves(runs["cpu", torch.float32]))
    floor32 = leaf_rel_errs(leaves(runs["cpu", torch.float32]), leaves(ref))
    names = ref["names"]
    worst = sorted(range(len(rel32)), key=lambda i: -rel32[i])[:3]
    return {"losses_cpu": {"l_D": ref["loss_d"], **ref["logs"]}, "upd_d": {f"{d} {str(t)[6:]}": r["upd_d"]
                                                                          for (d, t), r in runs.items()},
            "float64": {"loss_rel_err_max": max(loss_errs(card, ref).values()), "grad_rel_err_max": max(rel64),
                        "grad_rel_err_d": whole(card["grads_d"], ref["grads_d"]),
                        "grad_rel_err_g": whole(card["grads_g"], ref["grads_g"]), "grad_leaves": len(rel64)},
            "float32": {"loss_rel_errs": loss_errs(runs["cuda", torch.float32], runs["cpu", torch.float32]),
                        "grad_rel_err_d": whole(runs["cuda", torch.float32]["grads_d"],
                                                runs["cpu", torch.float32]["grads_d"]),
                        "grad_rel_err_g": whole(runs["cuda", torch.float32]["grads_g"],
                                                runs["cpu", torch.float32]["grads_g"]),
                        "grad_rel_err_max": max(rel32), "cpu_floor_max": max(floor32),
                        "worst_leaves": [[names[i], rel32[i], floor32[i]] for i in worst]}}


def write_vgg19(path: Path, seed: int = 13) -> None:
    """A torchvision vgg19 `features` state dict with seeded He weights."""
    from sharkshark_tpu_torch.train.vgg import VGG19_LAYERS

    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for entry in VGG19_LAYERS:
        if entry == "M":
            continue
        i, cout = entry
        sd[f"features.{i}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * (2.0 / (cin * 9)) ** 0.5
        sd[f"features.{i}.bias"] = torch.zeros(cout)
        cin = cout
    torch.save(sd, path)


def run_gan_recipe(driver, counters, data: Path, tmp: Path, card: str) -> dict:
    """The GAN recipe (configs/tecogan_bd.yml) through the driver on the
    card: train 30 iterations (checkpoints at 10, 20, 30) and resume from
    the 20th, through the step's graph; the step timed eager and through
    its graph under the config's adaptive policy, and through its graph
    under 'always' and an adaptive threshold no distance reaches (the
    cost of the device blend of D's update); the graph against the eager
    step (the D decisions among them), the capturable Adam against the
    plain one; one step held against the CPU; the resume on the card;
    test mode from the run's checkpoint and then from the minted FRNet
    through one inference cache (the second replays its graph), K3 once
    a frame, on the card and the CPU."""
    res = {"cuts": GAN_CUTS}
    opt = gan_config(driver, data, tmp)
    cfg_path = write_config(opt, tmp / "gan.yml")
    with cudnn_tf32(True):
        counters.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = driver.main(["--config", cfg_path, "--mode", "train"])
        res["train_wall_s"] = time.perf_counter() - t0
        res["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["train_launches"] = counters.read()
        k = GAN_CKPT_FREQ
        g_losses, d_losses = run["logs"]["l_total_G"], run["logs"]["l_gan_D"]
        assert run["iter"] == GAN_ITERS and len(g_losses) == GAN_ITERS, run["iter"]
        assert all(np.isfinite(g_losses)) and all(np.isfinite(d_losses)), (g_losses, d_losses)
        res.update(cnt_upd_d=run["cnt_upd_d"], loss_g_first10=float(np.mean(g_losses[:k])),
                   loss_g_last10=float(np.mean(g_losses[-k:])), loss_d_first10=float(np.mean(d_losses[:k])),
                   loss_d_last10=float(np.mean(d_losses[-k:])), logs=run["logs"])
        assert res["loss_g_last10"] < res["loss_g_first10"], res
        assert sum(v != 0.0 for v in d_losses) == run["cnt_upd_d"]
        want = [f"ckpt_{i:09d}" for i in range(k, GAN_ITERS + 1, k)]
        assert [Path(p).name for p in run["checkpoints"]] == want, run["checkpoints"]
        # training runs no kernel: the warps are the plain gather (K3 has no backward)
        assert not any(res["train_launches"].values()), res["train_launches"]
        res["step_graphs"] = run["step_graphs"]
        assert run["step_graphs"] == {"signatures": 1, "graphs": 1}, run["step_graphs"]
        os.remove(run["checkpoints"][-1])
        rerun = driver.main(["--config", cfg_path, "--mode", "train"])
        assert Path(rerun["resumed_from"]).name == want[-2], rerun["resumed_from"]
        assert rerun["iter"] == GAN_ITERS and len(rerun["losses"]) == k and all(np.isfinite(rerun["losses"]))
        res["resumed_losses"] = rerun["losses"]
        batches = loader_batches(driver, opt, 6)
        batch = {"lr": batches[0][0].cpu().numpy(), "gt": batches[0][1].cpu().numpy()}
        res["timing"] = time_train_step(driver, opt, batch)
        for label, policy in (("always", {"update_policy": "always"}),
                              ("adaptive_never_skips", {"update_threshold": 1e9})):
            popt = {**opt, "train": {**opt["train"], "discriminator": {**opt["train"]["discriminator"], **policy}}}
            res[f"timing_{label}"] = time_train_step(driver, popt, batch, routes=("graphs",))
        res["blend_ms"] = (res["timing_adaptive_never_skips"]["graphs"]["ms_per_iter"]
                           - res["timing_always"]["graphs"]["ms_per_iter"])
        res["graphs_vs_eager"] = gve = check_graphs_on_card(driver, opt, batches)
        assert gve["deterministic_bit_identical"] and gve["graphs"] == {"signatures": 1, "graphs": 1}, gve
        res["capturable_adam"] = check_capturable_adam(driver, opt)
        assert res["capturable_adam"]["rel"] <= 1e-4, res["capturable_adam"]
        res["resume"] = check_resume_on_card(driver, opt, batches[:4], tmp / "gan")
        assert res["resume"]["deterministic_bit_identical"], res["resume"]
    with cudnn_tf32(False):
        res["card_vs_cpu"] = cmp = check_gan_step_against_cpu(driver, opt, batches[0][0], batches[0][1])
        f64 = cmp["float64"]
        assert f64["loss_rel_err_max"] <= 1e-6 and f64["grad_rel_err_max"] <= 1e-5, cmp
        assert cmp["upd_d"]["cuda float64"] == cmp["upd_d"]["cpu float64"], cmp
        # test mode from the run's checkpoint: FRNet's inference, K3 once a
        # frame.  Its seeded generator's recurrence diverges, and carries
        # float32 differences from frame to frame, so its frames are
        # reported and the sequence's PSNR held; the frames are held on
        # the minted FRNet (a trained, stable recurrence) in the same config
        infer = driver.ShapeCache(driver.define_generator(opt, "cuda")["infer"])
        res["test"] = run_gan_test(driver, counters, opt, opt["train"]["ckpt_dir"], tmp / "res_gan", infer)
        assert abs(res["test"]["psnr_card"] - res["test"]["psnr_cpu"]) <= 0.05, res["test"]
        res["test_minted"] = run_gan_test(driver, counters, opt, str(MINTED / "egvsr-derived-x4.pth"),
                                          tmp / "res_gan_minted", infer)
        res["test_graphs"] = {"signatures": infer.num_signatures, "graphs": infer.num_graphs}
        assert res["test_graphs"] == {"signatures": 1, "graphs": 1}, res["test_graphs"]
        assert abs(res["test_minted"]["psnr_card"] - res["test_minted"]["psnr_cpu"]) <= 0.05, res["test_minted"]
        assert min(res["test_minted"]["frame_psnr_card_vs_cpu_db"]) >= 45.0, res["test_minted"]
    log(f"GAN training (configs/tecogan_bd.yml, FRNet nf 64 nb 10 + spatio-temporal D, crop 128, batch 4, T "
        f"{GAN_TEMPO} -> {2 * GAN_TEMPO - 1} with ping-pong) on {card}; cuts: {'; '.join(GAN_CUTS)}: "
        f"{GAN_ITERS} iterations in {res['train_wall_s']:.3f} s, peak {res['train_peak_gb']:.3f} GB, D updated "
        f"{res['cnt_upd_d']} of {GAN_ITERS}; G loss {res['loss_g_first10']:.1f} -> {res['loss_g_last10']:.1f}, D loss "
        f"{res['loss_d_first10']:.4f} -> {res['loss_d_last10']:.4f} (mean of the first / last {k}), through the "
        f"step's graphs ({res['step_graphs']}); step {train_timing_text(res['timing'])}; through the graphs "
        f"'always' {res['timing_always']['graphs']['ms_per_iter']:.3f} ms, adaptive that never skips "
        f"{res['timing_adaptive_never_skips']['graphs']['ms_per_iter']:.3f} ms (the D blend: {res['blend_ms']:.3f} "
        f"ms); graphs against eager {gve}; capturable Adam against the plain one {res['capturable_adam']}; resume "
        f"on the card {res['resume']}; card vs CPU (one sample), float64: "
        f"losses "
        f"{cmp['float64']['loss_rel_err_max']:.2e}, grads D {cmp['float64']['grad_rel_err_d']:.2e} G "
        f"{cmp['float64']['grad_rel_err_g']:.2e} (whole), {cmp['float64']['grad_rel_err_max']:.2e} (max of "
        f"{cmp['float64']['grad_leaves']} leaves); float32: grads D {cmp['float32']['grad_rel_err_d']:.2e} G "
        f"{cmp['float32']['grad_rel_err_g']:.2e}, the worst [leaf, card vs CPU, CPU float32 vs float64]: "
        f"{cmp['float32']['worst_leaves']}; D decision {cmp['upd_d']}; test through one inference cache "
        f"({res['test_graphs']}), K3 from the run's "
        f"checkpoint: {res['test']['launches']['backward_warp']} launches, {res['test']['ms_per_frame']:.3f} ms a "
        f"frame, PSNR {res['test']['psnr_card']:.4f} dB (CPU {res['test']['psnr_cpu']:.4f}), frames against the "
        f"CPU's {[round(v, 2) for v in res['test']['frame_psnr_card_vs_cpu_db']]} dB; from the minted FRNet: "
        f"PSNR {res['test_minted']['psnr_card']:.4f} dB (CPU {res['test_minted']['psnr_cpu']:.4f}), frames "
        f"{min(res['test_minted']['frame_psnr_card_vs_cpu_db']):.2f}-"
        f"{max(res['test_minted']['frame_psnr_card_vs_cpu_db']):.2f} dB against the CPU's, "
        f"{res['test_minted']['launches']['backward_warp']} K3 launches through the replayed graph, "
        f"{res['test_minted']['ms_per_frame']:.3f} ms a frame")
    return res


def run_gan_test(driver, counters, opt: dict, load_path: str, res_dir: Path, infer) -> dict:
    """The GAN config's test mode with generator weights from `load_path`
    on the card (through `infer`, the inference cache the calls share:
    K3 once a frame, nothing else launched) and on the CPU; each frame's
    PSNR card against CPU."""
    topt = {**opt, "model": {**opt["model"], "generator": {**opt["model"]["generator"], "load_path": load_path}}}
    topt["test"] = {**opt["test"], "res_dir": str(res_dir / "card")}
    counters.reset()
    t0 = time.perf_counter()
    card_res = driver.test(topt, device="cuda", infer=infer)["test1"]
    wall = time.perf_counter() - t0
    launches = counters.read()
    frames = sorted((res_dir / "card").rglob("*.png"))
    assert launches == {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": len(frames),
                        "fused_conv_stack": 0} and len(frames) == GAN_TEMPO, (launches, len(frames))
    topt["test"]["res_dir"] = str(res_dir / "cpu")
    psnr_cpu = driver.test(topt, device="cpu")["test1"]["PSNR"]
    frame_db = [psnr(np.asarray(_png(f)), np.asarray(_png(res_dir / "cpu" / f.relative_to(res_dir / "card"))))
                for f in frames]
    return {"load_path": load_path, "launches": launches, "frames": len(frames),
            "ms_per_frame": wall * 1e3 / len(frames), "psnr_card": card_res["PSNR"], "psnr_cpu": psnr_cpu,
            "frame_psnr_card_vs_cpu_db": frame_db}


def minted_gan_recipe(driver, opt: dict):
    """The config's GAN recipe on the card with its generator started from
    the minted FRNet (weights/minted/egvsr-derived-x4.pth, nf 64 nb 10):
    a trained, stable recurrence, as TecoGAN fine-tunes a pretrained one.
    (The seeded FRNet's 19-frame recurrence grows its output ~7x a frame,
    to ~1e16, where VGG19's features overflow float32.)"""
    from sharkshark_tpu_torch.models import egvsr
    from sharkshark_tpu_torch.models.torch_import import load_state_dict
    from sharkshark_tpu_torch.train import vsr

    recipe = driver.build_training(opt, "cuda")
    minted = egvsr.from_torch(load_state_dict(str(MINTED / "egvsr-derived-x4.pth")), recipe.cfg.model_cfg)
    with torch.no_grad():
        for dst, src in zip(vsr.param_leaves(recipe.state.params_g), vsr.param_leaves(minted)):
            dst.copy_(src)
    return recipe


def run_gan_snet_vgg(driver, data: Path, tmp: Path, card: str, iters: int = 6) -> dict:
    """A short GAN run with the spatial D (SNet, conditional) and the VGG
    feature loss on a seeded VGG19 written to `tmp`, its generator started
    from the minted FRNet: `iters` steps on the driver's batches, then its
    step against the same step without the feature loss.  Random VGG
    weights: this gives the perceptual loss's cost, not its quality."""
    write_vgg19(tmp / "vgg19.pth")
    opt = gan_config(driver, data, tmp, name="gan_snet")
    opt["model"]["discriminator"].update(name="SNet", use_cond=True)
    plain = {**opt, "train": dict(opt["train"])}
    opt["train"]["feature_crit"] = {"type": "CB", "weight": 0.2, "vgg_weights": str(tmp / "vgg19.pth")}
    res = {}
    with cudnn_tf32(True):
        recipe = minted_gan_recipe(driver, opt)
        assert recipe.cfg.disc_type == "spatial" and recipe.cfg.disc_cfg.use_cond
        batches = loader_batches(driver, opt, iters)
        t0 = time.perf_counter()
        logs = [recipe.step(recipe.state, lr, gt)[1] for lr, gt in batches]
        res["train_wall_s"] = time.perf_counter() - t0
        res["l_feat_G"] = [float(x["l_feat_G"]) for x in logs]
        res["l_total_G"] = [float(x["l_total_G"]) for x in logs]
        res["cnt_upd_d"] = int(recipe.state.cnt_upd_d)
        res["step_graphs"] = {"signatures": recipe.step.num_signatures, "graphs": recipe.step.num_graphs}
        assert all(np.isfinite(res["l_feat_G"] + res["l_total_G"])), res
        batch = {"lr": batches[0][0].cpu().numpy(), "gt": batches[0][1].cpu().numpy()}
        res["timing_vgg"] = time_train_step(driver, opt, batch, iters=6, routes=("graphs",),
                                            recipes={"graphs": minted_gan_recipe(driver, opt)})
        res["timing_no_vgg"] = time_train_step(driver, plain, batch, iters=6, routes=("graphs",),
                                               recipes={"graphs": minted_gan_recipe(driver, plain)})
    res["vgg_cost_ms"] = res["timing_vgg"]["graphs"]["ms_per_iter"] - res["timing_no_vgg"]["graphs"]["ms_per_iter"]
    log(f"GAN, spatial D (conditional) + VGG19 feature loss on seeded weights (its cost, not its quality), G from "
        f"the minted FRNet, on {card}: {iters} steps in {res['train_wall_s']:.3f} s, D updated {res['cnt_upd_d']}, "
        f"l_feat_G {res['l_feat_G'][0]:.4f} -> {res['l_feat_G'][-1]:.4f}, l_total_G {res['l_total_G'][0]:.1f} -> "
        f"{res['l_total_G'][-1]:.1f} (the step's graphs {res['step_graphs']}); step through its graph "
        f"{res['timing_vgg']['graphs']['ms_per_iter']:.3f} ms with the VGG loss, "
        f"{res['timing_no_vgg']['graphs']['ms_per_iter']:.3f} without ({res['vgg_cost_ms']:.3f} ms; "
        f"{res['timing_vgg']['gflop']:.1f} / {res['timing_no_vgg']['gflop']:.1f} GFLOP; median of 6 after 3), pool "
        f"{res['timing_vgg']['graphs']['pool_gb']:.3f} GB")
    return res


def check_variants(driver, tmp: Path, card: str) -> dict:
    """ESPCN, VESPCN and SOF-VSR at their default (Y-channel) configs with
    seeded weights on a 180x320 LR input (720p / 4) from three panning
    frames, float32: the card (TF32 off) against the CPU by PSNR over the
    CPU output's peak (>= 55 dB, the CPU output's std >= 0.05), ms a call
    on the card; then the driver's profile mode at the same size."""
    from sharkshark_tpu_torch.models import variants as V
    from sharkshark_tpu_torch.models.torch_import import to_tensors

    h, w = VARIANT_LR
    rgb = make_frames(3, h, w, seed=13).astype(np.float32) / 255.0
    y = torch.from_numpy(rgb @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]  # (3, h, w, 1)
    cases = {
        "espnet": (V.espcn_init, V.espcn_apply, V.ESPCNConfig(), y[1:2], {}),
        "vespnet": (V.vespcn_init, V.vespcn_apply, V.VESPCNConfig(), y, {"channel": 1}),
        "sofnet": (V.sofvsr_init, V.sofvsr_apply, V.SOFVSRConfig(), y[..., 0].permute(1, 2, 0)[None], {}),
    }
    res = {}
    for name, (init, apply, cfg, x, gen_opt) in cases.items():
        params = init(torch.Generator().manual_seed(13), cfg)
        with torch.no_grad(), cudnn_tf32(False):
            want = apply(params, x, cfg=cfg)
            pc, xc = to_tensors(params, "cuda"), x.cuda()
            got = apply(pc, xc, cfg=cfg).cpu()
            want64 = apply(to_tensors(params, "cpu", torch.float64), x.double(), cfg=cfg)
            got64 = apply(to_tensors(params, "cuda", torch.float64), xc.double(), cfg=cfg).cpu()
            times = []
            for i in range(12):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                apply(pc, xc, cfg=cfg)
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
        peak = float(want.abs().max())

        def db(a, b):
            mse = float(((a.double() - b.double()) ** 2).mean())
            return float("inf") if mse == 0 else float(10 * np.log10(peak**2 / mse))

        r = {"shape": list(want.shape), "std_cpu": float(want.std()), "peak_cpu": peak,
             "psnr_card_vs_cpu_db": db(got, want), "psnr_card_vs_cpu_float64_db": db(got64, want64),
             "psnr_cpu_float32_vs_float64_db": db(want, want64),
             "max_abs_err": float((got - want).abs().max()), "ms_card": statistics.median(times)}
        assert r["psnr_card_vs_cpu_db"] >= 55.0 and r["std_cpu"] >= 0.05, (name, r)
        popt = {"scale": 4, "model": {"generator": {"name": name, "in_nc": 1, "out_nc": 1, **gen_opt}},
                "test": {"profile_size": [h, w]}}
        with cudnn_tf32(True):
            prof = driver.main(["--config", write_config(popt, tmp / f"{name}.yml"), "--mode", "profile"])
        r.update(profile_gflop=prof["flops"] / 1e9, profile_calls_per_s=prof["fps"], params=prof["params"])
        res[name] = r
        log(f"variant {name} at {h}x{w} -> {want.shape[1]}x{want.shape[2]} on {card}: card vs CPU "
            f"{r['psnr_card_vs_cpu_db']:.2f} dB (peak {peak:.3f}, CPU std {r['std_cpu']:.4f}; in float64 "
            f"{r['psnr_card_vs_cpu_float64_db']:.2f} dB; the CPU's float32 vs its float64 "
            f"{r['psnr_cpu_float32_vs_float64_db']:.2f} dB), {r['ms_card']:.3f} ms a "
            f"call (median of 10); profile {r['profile_gflop']:.3f} GFLOP, {r['profile_calls_per_s']:.2f} calls/s, "
            f"{r['params']} params")
    return res


def run_tools(tmp: Path, data: Path, gan_test: dict, card: str) -> dict:
    """export_torch_{egvsr,srvgg,bsvd} on phase 12's and this phase's
    checkpoints (each reads its file back through from_torch), and
    quality_eval on the GAN test's frames, its PSNR against test mode's."""
    from sharkshark_tpu_torch.tools import export_torch_bsvd, export_torch_egvsr, export_torch_srvgg, quality_eval

    out = tmp / "exports"
    res = {"exports": {
        "egvsr (phase 12, FRNet)": export_torch_egvsr.main(
            ["--ckpt", str(tmp / "ckpt_frnet"), "--out", str(out / "egvsr-frnet.pth"), "--nb", "10"]),
        "egvsr (phase 13, the GAN's G)": export_torch_egvsr.main(
            ["--ckpt", str(tmp / "ckpt_gan"), "--out", str(out / "egvsr-gan.pth"), "--nb", "10",
             "--degradation", "BD"]),
        "srvgg (phase 12)": export_torch_srvgg.main(
            ["--ckpt", str(tmp / "ckpt_srvgg"), "--out", str(out / "srvgg.pth"), "--num-conv", "32"]),
        "bsvd (phase 12)": export_torch_bsvd.main(
            ["--ckpt", str(tmp / "ckpt_bsvd"), "--out", str(out / "bsvd.pth")]),
    }}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        q = quality_eval.main(["--gt", str(data / "val" / "GT"), "--pred", str(tmp / "res_gan" / "card" / "test1"),
                               "--metrics", "PSNR", "tOF", "LPIPS", "--json", str(tmp / "quality.json")])
    res["quality_eval"] = {**q["average"], "wall_s": time.perf_counter() - t0}
    assert abs(q["average"]["PSNR"] - gan_test["psnr_card"]) <= 1e-6, (q, gan_test)
    log(f"tools on {card}: {json.dumps(res)}")
    return res


def run_gan_phase(counters, card: str, tmp: Path) -> dict:
    """Phase 13: the GAN recipe, a spatial-D + VGG run, the variants and
    the tools, in phase 12's `tmp` (its stills and checkpoints)."""
    from sharkshark_tpu_torch.train import driver

    t_phase = time.perf_counter()
    res = {"variants": check_variants(driver, tmp, card)}
    data = write_gan_data(tmp)
    res["gan"] = run_gan_recipe(driver, counters, data, tmp, card)
    res["gan_snet_vgg"] = run_gan_snet_vgg(driver, data, tmp, card)
    res["tools"] = run_tools(tmp, data, res["gan"]["test"], card)
    res["wall_s"] = time.perf_counter() - t_phase
    return res


# -------------------------------------------------------------- phase 14


def run_single_denoise(counters, card: str, chunked_out: np.ndarray, n: int = 24) -> dict:
    """steps.upscale_single_denoise (bsvd.stream_step, one frame a call,
    the reference's own dataflow) over the first n frames that the main
    path's service ran, with the minted weights as the service holds them
    (bf16 on the card): no K1 launch, and its frames j >= SHIFT_NUM, which
    blend frame j with the denoised frame j - SHIFT_NUM as the chunked
    service's frame j does, against the service's by PSNR."""
    from sharkshark_tpu_torch.models import bsvd, srvgg, torch_import
    from sharkshark_tpu_torch.upscale import steps

    dev, dtype = torch.device("cuda"), torch.bfloat16
    spec = steps.UpscaleSpec(lr_shape=(720, 1280), output_shape=(1440, 2560), denoise_rate=0.75,
                             compute_dtype=dtype)
    params = torch_import.to_tensors({
        "sr": srvgg.from_torch(torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))),
        "denoise": bsvd.from_torch(torch_import.load_state_dict(str(MINTED / "bsvd-derived-32.pth"))),
    }, dev, dtype)
    stack = srvgg.resolve_conv_stack(srvgg.GENERAL_X4V3, None)

    def sr_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=stack)

    frames = make_frames(32, 720, 1280, seed=7)[:n]  # run_main_path's frames
    state = steps.init_denoise_state(1, spec, device=dev)
    outs = []
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for f in frames:
            out, state = steps.upscale_single_denoise(sr_apply, params, state,
                                                      torch.from_numpy(f[None]).to(dev), spec)
            outs.append(out.cpu().numpy())
    wall = time.perf_counter() - t0
    launches = counters.read()
    assert launches["tsm_conv"] == 0 and launches["fused_conv_stack"] == n * 32, launches
    single = np.concatenate(outs)
    k = bsvd.SHIFT_NUM
    value = psnr(single[k:], chunked_out[k:n])
    res = {"frames": n, "launches": launches, "ms_per_frame": wall / n * 1e3,
           "psnr_vs_chunked_service_db": value, "compared_frames": [k, n]}
    log(f"upscale_single_denoise, {n} frames at 720p->1440p with the minted BSVD-32 on {card}: "
        f"{res['ms_per_frame']:.3f} ms/frame (host clock, fetch included), launches {launches}; frames "
        f"{k}..{n - 1} against the chunked service's: PSNR {value:.3f} dB (min 40)")
    assert value >= 40.0, "the per-frame stream disagrees with the chunked service"
    return res


def check_apply_down(counters, card: str) -> list[dict]:
    """srvgg.apply_down at d = 2, 3, 4 on a 720p frame (720x1278 for d=3,
    whose H and W must divide by 3) with the minted weights in bf16, the
    body through K4 (32 launches a call) against the layer-by-layer body,
    by PSNR of the clamped outputs, and each timed (CUDA events, median of
    10)."""
    from sharkshark_tpu_torch.models import srvgg, torch_import
    from sharkshark_tpu_torch.tools import bench_tsm_conv as bench

    dev, dtype = torch.device("cuda"), torch.bfloat16
    params = torch_import.to_tensors(
        srvgg.from_torch(torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))), dev, dtype)
    stack = srvgg.resolve_conv_stack(srvgg.GENERAL_X4V3, None)
    x = torch.from_numpy(make_frames(1, 720, 1280, seed=23)).to(dev).to(dtype) / 255
    rows = []
    with torch.inference_mode():
        for d in (2, 3, 4):
            xd = x[:, :, : 1278 if d == 3 else 1280].contiguous()
            counters.reset()
            got = srvgg.apply_down(params, xd, d, conv_stack=stack)
            torch.cuda.synchronize()
            launches = counters.read()["fused_conv_stack"]
            want = srvgg.apply_down(params, xd, d, conv_stack=0)

            def u8(y):
                return (y.float().clamp(0, 1) * 255).cpu().numpy()

            row = {"d": d, "in": list(xd.shape), "out": list(got.shape), "k4_launches": launches,
                   "psnr_vs_layer_by_layer_db": psnr(u8(got), u8(want)),
                   "ms": bench.time_ms(lambda: srvgg.apply_down(params, xd, d, conv_stack=stack), reps=10),
                   "layer_by_layer_ms": bench.time_ms(lambda: srvgg.apply_down(params, xd, d, conv_stack=0),
                                                      reps=10)}
            rows.append(row)
            log(f"apply_down d={d} {tuple(xd.shape)} -> {tuple(got.shape)} bf16 on {card}: K4 {launches} "
                f"launches, {row['ms']:.3f} ms (layer by layer {row['layer_by_layer_ms']:.3f} ms), PSNR vs the "
                f"layer-by-layer body {row['psnr_vs_layer_by_layer_db']:.3f} dB (min 40)")
            assert launches == 32, launches
            assert got.shape == (1, 4 * xd.shape[1] // d, 4 * xd.shape[2] // d, 3)
            assert row["psnr_vs_layer_by_layer_db"] >= 40.0, row
    return rows


def run_exports(tmp: Path, card: str) -> dict:
    """tools/export_model.py for srvgg and egvsr at 1x360x640x3 on the card
    (bf16): exported with K4 and K3 as operator calls, saved, reloaded,
    run against the eager function, its kernel launches counted through
    the reloaded program, and its speed test."""
    from sharkshark_tpu_torch.tools import export_model

    want = {"srvgg": {"tsm_conv": 0, "backward_warp": 0, "conv_stack": 32},
            "egvsr": {"tsm_conv": 0, "backward_warp": 1, "conv_stack": 0}}
    res = {}
    for model, launches in want.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            r = export_model.main(["--model", model, "--shape", "1,360,640,3", "--out",
                                   str(tmp / f"{model}.pt2"), "--speed-test", "--iters", "10"])
        r["wall_s"] = time.perf_counter() - t0
        res[model] = r
        log(f"export_model {model} 1x360x640x3 bf16 on {card}: ops {r['kernel_ops']}, {r['bytes']} bytes, "
            f"reloaded max|err| vs eager {r['max_abs_err']:.4g}, launches through the program "
            f"{r['launches']}, speed test {r['ms']:.3f} ms/iter (eager {r['eager_ms']:.3f}), "
            f"{r['wall_s']:.1f} s in all")
        assert r["launches"] == launches, (model, r["launches"])
        assert r["out_shape"] == [1, 1440, 2560, 3]
    return res


def run_bsvd64_phase(service_mod, counters, bench, tsm, card: str, main_out: np.ndarray, tmp: Path) -> dict:
    """Phase 14: K1 at BSVD-64's C=128 shape; the denoise service with
    BSVD-64 (seeded weights written by bsvd.to_torch, by path) and the
    minted SRVGG at 720p -> 1440p; the card against the CPU with BSVD-64;
    upscale_single_denoise against the chunked service; apply_down; and
    export_model."""
    from sharkshark_tpu_torch.models import bsvd

    t_phase = time.perf_counter()
    res = {"k1_c128_360x640": check_tsm_conv(tsm, bench, 128, 360, 640)}
    path = tmp / "bsvd-64-seeded.pth"
    torch.save(bsvd.to_torch(bsvd.init_params(torch.Generator().manual_seed(14), bsvd.BSVD_64)), path)
    defaults = {"tsm_pair": False, "conv_stack": 1}
    res["service"], _ = run_main_path(service_mod, counters, card, **defaults, denoise_weights=str(path),
                                      bsvd_cfg=bsvd.BSVD_64)
    res["service"]["k1_per_warm_chunk"] = k1_per_chunk(bsvd.BSVD_64)
    res["step_psnr_db"] = check_step_against_cpu(counters, **defaults, den_path=str(path), bsvd_cfg=bsvd.BSVD_64)
    res["single_denoise"] = run_single_denoise(counters, card, main_out)
    res["apply_down"] = check_apply_down(counters, card)
    res["export_model"] = run_exports(tmp, card)
    res["wall_s"] = time.perf_counter() - t_phase
    return res


# -------------------------------------------------------------- phase 15


def mesh_devices(n: int) -> list:
    """n mesh devices: the cards in turn where there are two or more, else
    cuda:0 n times (the bands then run one after another on one card)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count if count >= 2 else 0) for i in range(n)]


@contextlib.contextmanager
def kernel_shapes(tsm, cs):
    """The shapes of K1's and K4's calls on a card while the block runs
    (the steps call both through their modules): K1's (C, H, W) at T = 4,
    K4's (N, H, W)."""
    k1, k4 = tsm.tsm_conv, cs.fused_conv_stack
    shapes = {"tsm_conv": set(), "fused_conv_stack": set()}

    def rec_k1(x, *args, **kw):
        if x.device.type == "cuda":
            shapes["tsm_conv"].add((x.shape[-1], x.shape[-3], x.shape[-2]))
        return k1(x, *args, **kw)

    def rec_k4(x, *args, **kw):
        if x.device.type == "cuda":
            shapes["fused_conv_stack"].add(tuple(x.shape[:3]))
        return k4(x, *args, **kw)

    tsm.tsm_conv, cs.fused_conv_stack = rec_k1, rec_k4
    try:
        yield shapes
    finally:
        tsm.tsm_conv, cs.fused_conv_stack = k1, k4


@contextlib.contextmanager
def warp_bands():
    """The (x's shape, col0, W') of K3's calls on a card from the sharded
    EGVSR step while the block runs (parallel/sharded.py calls K3's
    wrapper by that name; a graph's replay calls no wrapper, its eager
    call and its capture do)."""
    from sharkshark_tpu_torch.parallel import sharded

    fast = sharded.backward_warp_fast
    seen = set()

    def rec(x, flow, **kw):
        if x.device.type == "cuda":
            seen.add((tuple(x.shape), kw.get("col0", 0), flow.shape[2]))
        return fast(x, flow, **kw)

    sharded.backward_warp_fast = rec
    try:
        yield seen
    finally:
        sharded.backward_warp_fast = fast


def check_warp_bands(bench_warp, seen: set, card: str) -> list[dict]:
    """K3 at the bands that phase 15's sharded EGVSR step gave it, which
    must be bench_backward_warp.BANDS of the 2880x5120 frame: against its
    plain version, bit for bit against the whole frame's kernel output at
    its columns, and timed beside the plain gather, F.grid_sample on the
    band and the band's bound (bench_backward_warp.measure_bands)."""
    bands = sorted((col0, wo) for _, col0, wo in seen)
    assert {shape for shape, _, _ in seen} == {bench_warp.SHAPE} and tuple(bands) == bench_warp.BANDS, \
        f"the sharded EGVSR step gave K3 {sorted(seen)}, expected the bands {bench_warp.BANDS} of {bench_warp.SHAPE}"
    rows = bench_warp.measure_bands(bands=bands)
    for row in rows:
        log(f"backward_warp {row['case']} of {tuple(row['frame'])} bf16: max|err| {row['max_abs_err']:.4g} (atol "
            f"{bench_warp.TOL}), identical to the whole frame's warp at its columns; kernel {row['kernel_ms']:.4f} ms "
            f"a call, {row['device_ms']:.4f} ms back to back; plain gather {row['plain_ms']:.4f} ms; F.grid_sample "
            f"{row['library_ms']:.4f} ms a call, {row['library_device_ms']:.4f} ms back to back; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bytes'] / 1e6:.1f} MB), "
            f"{100 * row['bound_share']:.1f}% of it back to back on {card}")
    return rows


def check_band_shapes(bench, bench_cs, shapes: dict, card: str) -> dict:
    """K1 and K4 against their plain versions (and timed) at every shape
    phase 15's denoise and SR-only services gave them: the bands' widths,
    which no other phase runs, and the whole frame's of the one-device
    runs beside them."""
    rows = {"tsm_conv": [], "fused_conv_stack": []}
    for c, h, w in sorted(shapes["tsm_conv"]):
        row = bench.measure(c, h, w, reps=5)
        rows["tsm_conv"].append({k: row[k] for k in ("c", "h", "w", "max_abs_err", "kernel_ms", "device_ms",
                                                     "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                     "library_device_ms")})
        log(f"tsm_conv at a band's C={c} {h}x{w} T=4: max|err| {row['max_abs_err']:.4g} (rtol=atol={bench.TOL}); "
            f"{row['device_ms']:.4f} ms back to back, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"ms, one cuDNN conv {row['library_device_ms']:.4f} ms back to back on {card}")
    for shape in sorted(shapes["fused_conv_stack"]):
        row = bench_cs.measure(1, True, shape=shape, reps=5)
        rows["fused_conv_stack"].append({k: row[k] for k in ("shape", "max_abs_err", "ref_max", "kernel_ms",
                                                              "device_ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "library_device_ms")})
        log(f"fused_conv_stack at a band's {tuple(row['shape'])}: max|err| {row['max_abs_err']:.4g} (limit "
            f"{bench_cs.TOL * max(row['ref_max'], 1.0):.4g}); {row['device_ms']:.4f} ms back to back, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, conv2d + bias + PReLU "
            f"{row['library_device_ms']:.4f} ms back to back on {card}")
        assert row["max_abs_err"] <= bench_cs.TOL * max(row["ref_max"], 1.0), row
    return rows


def band_graphs(svc) -> dict:
    """The graphs that each band of a mesh service's factories holds
    (parallel/sharded.py's band_caches), by band position and then by
    factory and phase."""
    factories = {n.strip("_"): getattr(svc, n) for n in ("_sharded_multi", "_sharded_flush", "_step")
                 if hasattr(svc, n)}
    factories.update({"warm" if w else "cold": f for w, f in getattr(svc, "_sharded_denoise", {}).items()})
    out = {}
    for name, f in factories.items():
        for (phase, pos), cache in getattr(f, "band_caches", {}).items():
            out.setdefault(str(pos), {})[f"{name}.{phase}"] = cache.num_graphs
    return out


def run_mesh_service(service_mod, counters, card: str, name: str, make, frames: np.ndarray, batch: int,
                     devices: list, eager: bool = False, warm_up: bool = False) -> tuple[dict, np.ndarray, object]:
    """One service built by make() over `frames` in micro-batches, driven
    as the live pipeline drives it: its frames (the EOF drain's included),
    launches (K1's and K4's by device too), wall time, the spacing of its
    deliveries, the host's time in each dispatch (enqueueing the step,
    which waits for a device only where a copy must), the device memory
    allocated before the run and at its peak, and the graphs each band
    holds.  `eager`: the mesh's factories made as their eager reference
    (parallel.sharded._eager_reference), which captures no graph.
    `warm_up`: svc.warm_up() first (a one-device service, so that its
    stream replays its graphs).  Returns the service too, for the caller
    to time and close."""
    from sharkshark_tpu_torch.parallel import sharded

    with sharded._eager_reference() if eager else contextlib.nullcontext():
        svc = make()
        svc.proc_init()
    if warm_up:
        svc.warm_up(batch)
    host_s = []
    dispatch = svc.upscale_dispatch

    def timed(batch_frames):
        t = time.perf_counter()
        out = dispatch(batch_frames)
        host_s.append(time.perf_counter() - t)
        return out

    svc.upscale_dispatch = timed
    torch.cuda.synchronize()
    indices = sorted({d.index for d in devices})
    base = {d: torch.cuda.memory_allocated(d) / 1e9 for d in indices}
    for d in indices:
        torch.cuda.reset_peak_memory_stats(d)
    counters.reset()
    t0 = time.perf_counter()
    got, stamps, _ = drive(svc, service_mod.UpscalerQueueEntry,
                           [frames[i : i + batch] for i in range(0, len(frames), batch)])
    wall = time.perf_counter() - t0
    del svc.upscale_dispatch  # `timed` refers back to the service
    out = np.concatenate([np.asarray(e.frames) for e in got])
    res = {"run": name, "frames": len(out), "launches": counters.read(), "launches_by_device": counters.by_device(),
           "wall_s": wall, "stamps": stamps, "dispatch_ms": [v * 1e3 for v in host_s],
           "base_mem_gb_by_device": base,
           "peak_mem_gb_by_device": {d: torch.cuda.max_memory_allocated(d) / 1e9 for d in indices},
           # what the run itself added at its peak (a service made before it
           # may still hold its state)
           "peak_growth_gb_by_device": {d: (torch.cuda.max_memory_allocated(d) / 1e9) - base[d] for d in indices},
           "graphs_by_band": band_graphs(svc)}
    assert out.dtype == np.uint8 and out.shape[1:] == (1440, 2560, 3), (out.dtype, out.shape)
    if svc.mesh is not None:
        if eager:
            assert not res["graphs_by_band"], f"{name}: the eager reference holds graphs {res['graphs_by_band']}"
        else:
            assert res["graphs_by_band"] and min(sum(v.values()) for v in res["graphs_by_band"].values()) > 0, \
                f"{name}: a band holds no graph: {res['graphs_by_band']}"
    log(f"{name}: {len(out)} frames of 1440x2560x3 uint8, launches {res['launches']}, by device "
        f"{res['launches_by_device']}, wall {wall:.3f} s, graphs by band {res['graphs_by_band']}, device memory "
        "allocated before / at peak " + ", ".join(f"cuda:{d} {base[d]:.3f} / {v:.3f} GB"
                                                  for d, v in res["peak_mem_gb_by_device"].items()) + f" on {card}")
    return res, out, svc


def hold_identical(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """The mesh service through its bands' graphs against the same
    service's eager reference: identical bit for bit."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (got.shape, want.shape)
    differ = int((got != want).sum())
    log(f"{what}: through the bands' graphs against the eager factories "
        f"{'identical bit for bit' if not differ else f'DIFFERENT ({differ} values)'}")
    assert not differ, f"{what}: the graphs differ from the eager factories in {differ} values"


def host_split_ms(call, n: int = 6) -> dict:
    """Host ms a call of a mesh factory's step, one call at a time on an
    idle device, split by part: the halo refresh, the uploads (one a
    device), the bands' columns cut from them on the device, the bands'
    cache calls (the signature, the copies into static buffers, the
    replay, the output clones; or, in the eager reference, nothing), the
    colour statistics, the output gathers and EGVSR's HR gather; "other"
    is the rest of the call (an eager reference's band work among it).
    Medians over n calls; a part inside another counts to the outer."""
    from sharkshark_tpu_torch.parallel import _bands, sharded
    from sharkshark_tpu_torch.upscale import jit_cache

    parts = {"refresh": (_bands.ShardedState, "refresh"), "uploads": (sharded, "put_each"),
             "band slices": (sharded, "_band_cols"), "band caches": (jit_cache.ShapeCache, "__call__"),
             "statistics": (sharded, "_colour_stats"), "gathers": (sharded, "_gather_out"),
             "hr gather": (sharded, "_whole_hr")}
    spent, depth = {}, [0]

    def timed(name, fn):
        def wrapper(*args, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    spent[name] += time.perf_counter() - t0

        return wrapper

    originals = {name: getattr(owner, attr) for name, (owner, attr) in parts.items()}
    rows = []
    try:
        for name, (owner, attr) in parts.items():
            setattr(owner, attr, timed(name, originals[name]))
        for _ in range(n):
            spent.update({k: 0.0 for k in parts})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            total = time.perf_counter() - t0
            torch.cuda.synchronize()
            rows.append({**spent, "other": total - sum(spent.values()), "total": total})
    finally:
        for name, (owner, attr) in parts.items():
            setattr(owner, attr, originals[name])
    return {k: statistics.median(r[k] for r in rows) * 1e3 for k in rows[0]}


def mesh_graph_runs(service_mod, counters, card: str, what: str, make, frames: np.ndarray, batch: int,
                    devices: list, replayed_from: int, step_call, frames_per_call: int) -> dict:
    """A mesh service run through its eager reference, then through its
    bands' graphs, over the same frames: identical bit for bit, the host's
    dispatch in ms/frame (the eager run's warm dispatches from
    `replayed_from` on against the graphs' replayed ones, medians), the
    step's device ms/frame back to back (`step_call(svc)` after the
    stream, passes eager, graphs, graphs, eager) and each run's memory.
    Returns {"eager": ..., "graphs": ..., "timing": ...} and the graphs'
    output."""
    eres, eout, esvc = run_mesh_service(service_mod, counters, card, f"{what} (eager reference)", make, frames,
                                        batch, devices, eager=True)
    gres, gout, gsvc = run_mesh_service(service_mod, counters, card, f"{what} (bands' graphs)", make, frames, batch,
                                        devices)
    hold_identical(what, gout, eout)
    assert gres["launches"] == eres["launches"] and gres["launches_by_device"] == eres["launches_by_device"], \
        (gres["launches"], eres["launches"])
    with torch.inference_mode():
        passes = step_ms(lambda: step_call(esvc), lambda: step_call(gsvc))
        split = {"eager": host_split_ms(lambda: step_call(esvc)), "graphs": host_split_ms(lambda: step_call(gsvc))}
    esvc.close()
    gsvc.close()
    del esvc, gsvc
    timing = {"dispatch_ms_per_frame_eager": statistics.median(eres["dispatch_ms"][replayed_from:]) / batch,
              "dispatch_ms_per_frame_replay": statistics.median(gres["dispatch_ms"][replayed_from:]) / batch,
              "device_ms_per_frame_eager": statistics.mean(passes["eager"]) / frames_per_call,
              "device_ms_per_frame_replay": statistics.mean(passes["replay"]) / frames_per_call,
              "device_ms_passes": passes, "host_split_ms_per_call": split}
    log(f"{what}: the host's dispatch {timing['dispatch_ms_per_frame_eager']:.3f} ms/frame eager, "
        f"{timing['dispatch_ms_per_frame_replay']:.3f} replayed; the step back to back "
        f"{timing['device_ms_per_frame_eager']:.3f} ms/frame eager, {timing['device_ms_per_frame_replay']:.3f} "
        f"through the graphs; graphs by band {gres['graphs_by_band']}; peak memory by device, above what was "
        "allocated before the run, eager "
        + ", ".join(f"cuda:{d} {v:.3f}" for d, v in eres["peak_growth_gb_by_device"].items()) + " GB, graphs "
        + ", ".join(f"cuda:{d} {v:.3f}" for d, v in gres["peak_growth_gb_by_device"].items()) + f" GB on {card}")
    for k, row in split.items():
        log(f"{what}: host ms a step call on an idle device ({k}): "
            + ", ".join(f"{part} {v:.3f}" for part, v in row.items()) + f" on {card}")
    return {"eager": eres, "graphs": gres, "timing": timing}, gout


def run_mesh_denoise(service_mod, counters, card: str, n: int = 48, batch: int = 4) -> dict:
    """The denoise service (minted SRVGG general-x4v3 + BSVD-32, 720p ->
    1440p, bf16) on a 1x4 mesh, through its bands' graphs and through
    their eager reference, and on one device over the same n frames and
    the EOF drain: the graphs identical to the eager reference, PSNR >= 40
    dB against one device, 16 K1 and 32 K4 launches a chunk on each band,
    two warm graphs a band, and the warm step's ms/frame of each."""
    from sharkshark_tpu_torch.models import bsvd
    from sharkshark_tpu_torch.parallel import make_mesh

    devices = mesh_devices(4)
    mesh = make_mesh(devices=devices, spatial=4)
    frames = make_frames(n, 720, 1280, seed=29, pan=2)
    kw = dict(lr_level=3, output_shape=(1440, 2560), denoising=True, denoise_rate=0.75, batch_size=batch,
              weights=str(MINTED / "srvgg-derived-x4.pth"), denoise_weights=str(MINTED / "bsvd-derived-32.pth"))
    jobs, first_warm = n // batch, bsvd.SHIFT_NUM // batch
    # each ring phase's warm step runs eagerly once, is captured at its
    # second call and replays after
    first_replay = first_warm + 2 * (8 // batch)
    x = torch.from_numpy(frames[:batch])

    def warm_step(svc):
        _, svc._den_state = svc._sharded_denoise[True](svc._params, svc._den_state, x)

    graph_res, mout = mesh_graph_runs(service_mod, counters, card, "denoise service, mesh 1x4",
                                      lambda: service_mod.EsrganUpscalerService(**kw, mesh=mesh), frames, batch,
                                      devices, first_replay, warm_step, batch)
    sres, sout, ssvc = run_mesh_service(service_mod, counters, card, "denoise service, one device",
                                        lambda: service_mod.EsrganUpscalerService(**kw), frames, batch, devices,
                                        warm_up=True)
    ssvc.close()
    del ssvc
    mres, eres = graph_res["graphs"], graph_res["eager"]
    # delivered ms/frame over the warm chunks, the graphs' over their replays
    for res, out, first in ((mres, mout, first_replay), (eres, mout, first_warm), (sres, sout, first_warm)):
        stamps = res.pop("stamps")
        res["warm_ms_per_frame"] = (stamps[jobs - 1] - stamps[first - 1]) / ((jobs - first) * batch) * 1e3
        res["warm_dispatch_ms_per_frame"] = statistics.median(res["dispatch_ms"][first:jobs]) / batch
        assert len(out) == n + min(n, bsvd.SHIFT_NUM), f"{res['run']}: {len(out)} frames, expected the drain too"
    bands = 4  # 1280 LR columns in bands of 320
    chunks = n // batch + bsvd.SHIFT_NUM // batch
    want = {"tsm_conv": 16 * chunks * bands, "tsm_conv_pair": 0, "backward_warp": 0,
            "fused_conv_stack": 32 * chunks * bands}
    assert mres["launches"] == want, f"mesh denoise launches {mres['launches']}, expected {want}"
    per_dev = {}
    for d in devices:
        per_dev[d.index] = per_dev.get(d.index, 0) + 16 * chunks
    assert mres["launches_by_device"]["tsm_conv"] == per_dev, mres["launches_by_device"]
    value = psnr(mout, sout)
    warm_graphs = {k: v["warm.front"] for k, v in mres["graphs_by_band"].items()}
    assert warm_graphs == {str(k): 8 // batch for k in range(bands)}, f"warm graphs by band {warm_graphs}"
    log(f"denoise service, mesh 1x4 on {[str(d) for d in devices]} against one device: PSNR {value:.3f} dB "
        f"(min 40); warm step delivered {mres['warm_ms_per_frame']:.3f} ms/frame over the replays, "
        f"{eres['warm_ms_per_frame']:.3f} eager, {sres['warm_ms_per_frame']:.3f} one device; the host's dispatch "
        f"of a warm chunk {graph_res['timing']['dispatch_ms_per_frame_replay']:.3f} ms/frame replayed, "
        f"{graph_res['timing']['dispatch_ms_per_frame_eager']:.3f} eager, {sres['warm_dispatch_ms_per_frame']:.3f} "
        f"one device; warm graphs by band {warm_graphs}; per band and chunk 16 K1 and 32 K4 ({bands} bands, "
        f"{chunks} chunks) on {card}")
    assert value >= 40.0, "the sharded denoise service disagrees with the single-device one"
    return {"mesh": mres, "mesh_eager": eres, "timing": graph_res["timing"], "one_device": sres,
            "psnr_db": value, "bands": bands, "chunks": chunks, "devices": [str(d) for d in devices]}


def run_mesh_sr(service_mod, counters, card: str, jobs: int = 8, batch: int = 4) -> dict:
    """The SR-only service on a 2x2 mesh (batch over 'data', W over
    'spatial'), through its bands' graphs and their eager reference, and
    on one device: 8 micro-batches of 4, the graphs identical to the eager
    reference, PSNR >= 40 dB, 32 K4 launches a band and call (2 x 2 bands
    a call)."""
    from sharkshark_tpu_torch.parallel import make_mesh

    devices = mesh_devices(4)
    mesh = make_mesh(devices=devices, data=2, spatial=2)
    frames = make_frames(jobs * batch, 720, 1280, seed=31)
    kw = dict(lr_level=3, output_shape=(1440, 2560), denoising=False, batch_size=batch,
              weights=str(MINTED / "srvgg-derived-x4.pth"))
    x = torch.from_numpy(frames[:batch])

    def step(svc):
        svc._sharded_multi(svc._sr_params, x)

    # the first call runs eagerly, the second captures
    graph_res, mout = mesh_graph_runs(service_mod, counters, card, "SR-only service, mesh 2x2",
                                      lambda: service_mod.EsrganUpscalerService(**kw, mesh=mesh), frames, batch,
                                      devices, 2, step, batch)
    sres, sout, ssvc = run_mesh_service(service_mod, counters, card, "SR-only service, one device",
                                        lambda: service_mod.EsrganUpscalerService(**kw), frames, batch, devices,
                                        warm_up=True)
    ssvc.close()
    del ssvc
    mres = graph_res["graphs"]
    for res in (mres, graph_res["eager"], sres):
        stamps = res.pop("stamps")
        res["ms_per_frame"] = (stamps[-1] - stamps[0]) / ((jobs - 1) * batch) * 1e3
        res["dispatch_ms_per_frame"] = statistics.median(res["dispatch_ms"][1:]) / batch
    want = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": 0, "fused_conv_stack": 32 * jobs * 4}
    assert mres["launches"] == want, f"mesh SR-only launches {mres['launches']}, expected {want}"
    value = psnr(mout, sout)
    log(f"SR-only service, mesh 2x2 against one device: PSNR {value:.3f} dB (min 40); delivered "
        f"{mres['ms_per_frame']:.3f} ms/frame through the graphs, {graph_res['eager']['ms_per_frame']:.3f} eager, "
        f"{sres['ms_per_frame']:.3f} one device; the host's dispatch "
        f"{graph_res['timing']['dispatch_ms_per_frame_replay']:.3f} replayed / {sres['dispatch_ms_per_frame']:.3f} "
        f"one device ms/frame on {card}")
    assert value >= 40.0, "the sharded SR-only service disagrees with the single-device one"
    return {"mesh": mres, "mesh_eager": graph_res["eager"], "timing": graph_res["timing"], "one_device": sres,
            "psnr_db": value}


def run_mesh_egvsr(service_mod, counters, card: str, one_device: dict, one_out: np.ndarray, jobs: int = 6,
                   batch: int = 4) -> dict:
    """The EGVSR service (minted FRNet) on a 1x4 mesh over phase 6's 24
    frames, through its bands' graphs and their eager reference, against
    phase 6's single-device run: the graphs identical to the eager
    reference, PSNR >= 40 dB (51.571 dB with the plain gather), and one K3 launch a
    band and frame (each band warps its columns of the whole previous HR
    frame), replays included."""
    from sharkshark_tpu_torch.parallel import make_mesh

    devices = mesh_devices(4)
    mesh = make_mesh(devices=devices, spatial=4)
    frames = make_frames(jobs * batch, 720, 1280, seed=13)
    x = torch.from_numpy(frames[:1])

    def step(svc):
        _, svc._state = svc._step(svc._params, svc._state, x)

    # a dispatch runs 4 steps: the first's first two warm up and capture
    graph_res, out = mesh_graph_runs(
        service_mod, counters, card, "EGVSR service, mesh 1x4",
        lambda: service_mod.EgvsrUpscalerService(lr_level=3, output_shape=(1440, 2560),
                                                 weights=str(MINTED / "egvsr-derived-x4.pth"), mesh=mesh),
        frames, batch, devices, 1, step, 1)
    res = graph_res["graphs"]
    for r in (res, graph_res["eager"]):
        stamps = r.pop("stamps")
        r["ms_per_frame"] = (stamps[jobs - 1] - stamps[0]) / ((jobs - 1) * batch) * 1e3
    res["dispatch_ms_per_frame"] = graph_res["timing"]["dispatch_ms_per_frame_replay"]
    want = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": len(devices) * jobs * batch, "fused_conv_stack": 0}
    assert res["launches"] == want, f"the sharded EGVSR path launched {res['launches']}, expected {want}"
    value = psnr(out, one_out)
    log(f"EGVSR service, mesh 1x4 against one device: PSNR {value:.3f} dB (min 40; 51.571 with the plain "
        f"gather); backward_warp launches {res['launches']['backward_warp']} ({len(devices)} bands x "
        f"{jobs * batch} frames); delivered "
        f"{res['ms_per_frame']:.3f} ms/frame through the graphs (the host's dispatch "
        f"{res['dispatch_ms_per_frame']:.3f}), {graph_res['eager']['ms_per_frame']:.3f} eager, "
        f"{one_device['ms_per_frame']:.3f} one device; the step back to back "
        f"{graph_res['timing']['device_ms_per_frame_replay']:.3f} ms/frame through the graphs, "
        f"{graph_res['timing']['device_ms_per_frame_eager']:.3f} eager (with the plain gather: 10.636 "
        f"delivered on four cards) on {card}")
    assert value >= 40.0, "the sharded EGVSR service disagrees with the single-device one"
    return {"mesh": res, "mesh_eager": graph_res["eager"], "timing": graph_res["timing"], "psnr_db": value,
            "one_device_ms_per_frame": one_device["ms_per_frame"]}


def check_kernels_on_every_card(tsm, cs, card: str) -> list[dict]:
    """K1 (C = 64, 128) and K4 against their plain versions on each card,
    each card's first launch included: the shared-memory opt-in is made
    once a device.  Needs two or more cards."""
    rows = []
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        errs = {}
        for c, (h, w) in ((64, (360, 640)), (128, (180, 320))):
            x = torch.randn((4, 1, h, w, c), generator=g, device=dev).to(torch.bfloat16)
            prev = torch.randn((1, h, w, c), generator=g, device=dev).to(torch.bfloat16)
            left = torch.randn((1, h, w, c // 8), generator=g, device=dev).to(torch.bfloat16)
            wt = (torch.randn((3, 3, c, c), generator=g, device=dev) * 0.05).to(torch.bfloat16)
            b = (torch.randn((c,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
            got = tsm.tsm_conv(x, prev, left, wt, b, act="relu6").float()
            ref = tsm.tsm_conv_plain(x, prev, left, wt, b, act="relu6").float()
            errs[f"k1_c{c}"] = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
        x = torch.randn((4, 720, 1280, 64), generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((1, 3, 3, 64, 64), generator=g, device=dev) * 0.05).to(torch.bfloat16)
        a, b = torch.full((1, 64), 0.25, device=dev), torch.randn((1, 64), generator=g, device=dev) * 0.1
        got, ref = cs.fused_conv_stack(x, wt, a, b).float(), cs.fused_conv_stack_plain(x, wt, a, b).float()
        errs["k4"] = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
        log(f"cuda:{i} ({torch.cuda.get_device_name(i)}): K1 and K4 against their plain versions, "
            f"max error / max |ref|: {errs} (max 0.05)")
        assert max(errs.values()) <= 0.05, f"a kernel disagrees on cuda:{i}: {errs}"
        rows.append({"device": i, **errs})
    return rows


def run_mesh_phase(service_mod, counters, tsm, cs, bench, bench_cs, bench_warp, card: str, defaults: dict,
                   egvsr_res: dict, egvsr_out: np.ndarray) -> dict:
    """Phase 15: the sharded serving paths at full width, on the cards
    (two or more) or on cuda:0 repeated, K1, K4 and K3 against their plain
    versions at the bands' shapes, and the CLI with --mesh."""
    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    log(f"phase 15 mesh devices: {[str(d) for d in mesh_devices(4)]} ({count} card(s) visible; "
        + ("the bands run on distinct cards" if count >= 2 else "the four bands run one after another on one card")
        + ")")
    if count >= 2:
        peers = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
                 for i in range(count) for j in range(count) if i != j}
        log(f"peer access between the cards: {peers}")
    with kernel_shapes(tsm, cs) as shapes:
        res = {"cards": count, "denoise": run_mesh_denoise(service_mod, counters, card),
               "sr_only": run_mesh_sr(service_mod, counters, card)}
    res["band_kernels"] = check_band_shapes(bench, bench_cs, shapes, card)
    with warp_bands() as seen:
        res["egvsr"] = run_mesh_egvsr(service_mod, counters, card, egvsr_res, egvsr_out)
    res["band_kernels"]["backward_warp"] = check_warp_bands(bench_warp, seen, card)
    spatial = min(count, 4) if count >= 2 else 1
    n = 24
    want = {k: v * spatial for k, v in denoise_launches(4, n // 4 - 4, 4, **defaults).items()}
    res["cli"] = run_cli(counters, card, [(
        f"realesrgan+denoise --mesh 1,{spatial}",
        ["--weights", str(MINTED / "srvgg-derived-x4.pth"), "--denoise-weights", str(MINTED / "bsvd-derived-32.pth"),
         "--mesh", f"1,{spatial}"], n + min(n, 16), want)], n)
    res["per_card"] = check_kernels_on_every_card(tsm, cs, card) if count >= 2 else None
    if count < 2:
        log("one card visible: K1 and K4 on a second card, and peer copies between cards, are not measured here")
    res["wall_s"] = time.perf_counter() - t_phase
    return res


# -------------------------------------------------------------- phase 16


def train_clips(batch: int, t: int, crop: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lr, gt) training clips (N, T, crop/4, crop/4, 3) and (N, T, crop,
    crop, 3) in [0, 1]: a smooth random scene panning 3 px right and 2 px
    down a frame, and its 4x4 area downsample."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand((batch, 3, crop // 16 + 8, crop // 16 + 8), generator=g)
    scene = F.interpolate(coarse, scale_factor=16, mode="bicubic", align_corners=False).clamp(0, 1)
    gt = torch.stack([scene[:, :, 2 * i : 2 * i + crop, 3 * i : 3 * i + crop] for i in range(t)], dim=1)
    lr = F.avg_pool2d(gt.flatten(0, 1), 4).unflatten(0, (batch, t))
    return lr.permute(0, 1, 3, 4, 2).contiguous(), gt.permute(0, 1, 3, 4, 2).contiguous()


def mesh_order_grads(cfg, params: dict, lr: torch.Tensor, gt: torch.Tensor, data: int, bands: list) -> list:
    """The single-device step's arithmetic (egvsr.forward_sequence, the
    plain gather warp, the config's criteria) with its loss summed in the
    sharded step's order: a whole-clip forward of each data shard for
    each band, the pixel and warp criteria on the band's centre columns
    only, one backward of the sum.  Its gradient leaves, on lr's device."""
    from sharkshark_tpu_torch.models import egvsr
    from sharkshark_tpu_torch.ops.warp import backward_warp
    from sharkshark_tpu_torch.train import vsr
    from sharkshark_tpu_torch.train.losses import criterion_parts

    pix, warp = (criterion_parts(c or {"type": "CB"}) for c in (cfg.pixel_crit, cfg.warping_crit))
    n, t, h, w, c = lr.shape
    s, nb = cfg.model_cfg.scale, n // data
    sums = [0.0, 0.0]
    for r in range(data):
        x, y = lr[r * nb : (r + 1) * nb], gt[r * nb : (r + 1) * nb]
        for band in bands:
            out = egvsr.forward_sequence(params, x, cfg=cfg.model_cfg)
            hr = slice(s * band.c0, s * band.c1)
            sums[0] = sums[0] + pix[0](out["hr_data"][:, :, :, hr], y[:, :, :, hr])
            lr_warp = backward_warp(out["lr_prev"], out["lr_flow"])
            sums[1] = sums[1] + warp[0](lr_warp[:, :, band.c0 : band.c1], out["lr_curr"][:, :, band.c0 : band.c1])
    counts = (n * t * h * s * w * s * c, n * (t - 1) * h * w * c)
    loss = sum(weight * (total / count if mean else total) for weight, total, count, mean in
               zip((cfg.pixel_weight, cfg.warping_weight), sums, counts, (pix[1], warp[1])))
    loss.backward()
    return [p.grad.detach().clone() for p in vsr.param_leaves(params)]


def load_in_place(state, snap: list) -> None:
    """Write a state_snapshot back into the state's own tensors (as
    train/checkpoint.py loads): a compiled step keeps its signature and
    its graph."""
    from sharkshark_tpu_torch.train import compiled

    with torch.no_grad():
        for t, v in zip(compiled.state_tensors(state), snap):
            t.copy_(v)
    state.step = 0


def sharded_train_case(cfg, sched, params: dict, crop: int, batch: int, data: int, spatial: int,
                       iters: int = 4, t: int = 10) -> dict:
    """make_sharded_train_step on a data x spatial mesh of mesh_devices
    (on one card one device repeated: the whole body in one CUDA graph; on
    several, the per-band segment graphs), compiled as it is returned,
    against the single-device train step through its TrainStepCache, from
    the same weights on the same clips, on the card with TF32 off.  Each
    compared step is a replay: the compiled step's warm-up and capture
    run on the state, which is then loaded back to its start in place.
    In float32 the loss's relative error and every gradient leaf's
    ||delta|| / ||g|| beside the leaf's float32 floor (the single-device
    float32 gradient against the float64 one) and beside the same
    arithmetic summed in the mesh's order (mesh_order_grads) against the
    plain step, and the sharded step against that reading; in float64
    the same errors, which hold the sharding's arithmetic to the CPU
    tests' tolerances (loss 1e-5, leaves 1e-4) once rounding is out of
    the way.  Then the compiled sharded step against its eager step
    (check_sharded_graphs) and the four routes' times
    (time_sharded_routes)."""
    from sharkshark_tpu_torch.models.torch_import import to_tensors
    from sharkshark_tpu_torch.parallel import _bands, egvsr_radius, make_mesh, make_sharded_train_step
    from sharkshark_tpu_torch.train import compiled, vsr

    clips = train_clips(batch, t, crop, seed=crop)
    step = vsr.make_train_step(cfg, sched)
    mesh = make_mesh(devices=mesh_devices(4)[: data * spatial], data=data, spatial=spatial)
    make = {"one": lambda: compiled.TrainStepCache(step), "sharded": lambda: make_sharded_train_step(step, mesh)}

    def fresh(dtype):
        leaves = _bands.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                                 to_tensors(params, "cuda", dtype))
        return vsr.TrainState(leaves, vsr.make_optimizer(vsr.param_leaves(leaves), cfg.lr, cfg.beta1, cfg.beta2))

    def run(name, dtype):
        fn = make[name]()
        lr, gt = (x.to("cuda", dtype) for x in clips)
        state = fresh(dtype)
        start = state_snapshot(state)
        for _ in range(2):  # the warm-up and the capture
            fn(state, lr, gt)
        load_in_place(state, start)
        state, logs = fn(state, lr, gt)
        out = {"logs": {k: float(v) for k, v in logs.items()},
               "grads": [p.grad.detach().clone() for p in vsr.param_leaves(state.params)],
               "signatures": fn.num_signatures, "graphs": fn.num_graphs}
        del state, lr, gt, fn
        torch.cuda.empty_cache()
        return out

    bands = _bands.split_width(crop // 4, list(mesh.devices[0]), 8, egvsr_radius(cfg.model_cfg))
    wall = {}
    with cudnn_tf32(False):
        t0 = time.perf_counter()
        runs = {(name, dtype): run(name, dtype) for dtype in (torch.float32, torch.float64) for name in make}
        wall["against_one_device"] = time.perf_counter() - t0
        lr, gt = (x.to("cuda") for x in clips)
        t0 = time.perf_counter()
        ordered = mesh_order_grads(cfg, _bands.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                                                        to_tensors(params, "cuda")), lr, gt, data, bands)
        wall["mesh_order"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        same = check_sharded_graphs(make["sharded"], fresh, lr, gt)
        wall["graphs_vs_eager"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing = time_sharded_routes(step, make["sharded"](), fresh, lr, gt, iters)
        wall["timing"] = time.perf_counter() - t0
        del lr, gt
        torch.cuda.empty_cache()
    names = leaf_names(params)

    def errs(dtype):
        one, sh = runs["one", dtype], runs["sharded", dtype]
        return ({k: abs(sh["logs"][k] - one["logs"][k]) / abs(one["logs"][k]) for k in one["logs"]},
                leaf_rel_errs(sh["grads"], one["grads"]))

    loss32, rel32 = errs(torch.float32)
    loss64, rel64 = errs(torch.float64)
    floor = leaf_rel_errs(runs["one", torch.float32]["grads"], runs["one", torch.float64]["grads"])
    order = leaf_rel_errs(ordered, runs["one", torch.float32]["grads"])
    vs_order = leaf_rel_errs(runs["sharded", torch.float32]["grads"], ordered)
    worst = sorted(range(len(rel32)), key=lambda i: -rel32[i])[:3]
    return {"crop": crop, "batch": batch, "t": t, "data": data, "spatial": spatial,
            "devices": [str(d) for d in mesh.device_list], "route": same["route"],
            "bands_lr_cols": [[b.lo, b.c0, b.c1, b.hi] for b in bands],
            "loss_one": runs["one", torch.float32]["logs"]["l_total"],
            "loss_sharded": runs["sharded", torch.float32]["logs"]["l_total"],
            "loss_rel_err": loss32, "grad_rel_err_max": max(rel32), "grad_leaves": len(rel32),
            "worst_leaves": [[names[i], rel32[i], floor[i], order[i], vs_order[i]] for i in worst],
            "leaves_over_1e-4": [[names[i], rel32[i], order[i], vs_order[i]] for i in range(len(rel32))
                                 if rel32[i] > 1e-4],
            "mesh_order_rel_err_max": max(order), "vs_mesh_order_rel_err_max": max(vs_order),
            "leaves_over_bound": [names[i] for i in range(len(rel32))
                                  if rel32[i] > 1e-4 and (vs_order[i] > 1e-4 or rel32[i] > 2 * order[i])],
            "float64_loss_rel_err": loss64, "float64_grad_rel_err_max": max(rel64),
            "compared_graphs": {f"{name} {str(dtype)[6:]}": [r["signatures"], r["graphs"]]
                                for (name, dtype), r in runs.items()},
            "graphs_vs_eager": same, "timing": timing, "wall_s": wall}


def check_sharded_graphs(make, fresh, lr: torch.Tensor, gt: torch.Tensor, steps: int = 3) -> dict:
    """The compiled sharded step against its eager step (`fn.eager`) under
    deterministic algorithms, from one state on the same clips: the
    compiled step's warm-up and capture run first and its state is loaded
    back to the start in place, so that each of `steps` compared steps is
    a replay; every log of every step, the step's gradients, and at the
    end every tensor of the state and the count.  On one card (the whole
    body in one graph) they must be identical bit for bit.  Across cards
    each device's backward runs on its own autograd thread, so the order
    in which the first device adds the cards' gradient parts varies from
    run to run; there the first step's gradient leaves must lie within
    1e-5 of the eager step's, and the parameters' distance after the
    steps is read beside the distance between two eager runs (a second
    eager run, made across cards only)."""
    from sharkshark_tpu_torch.train import compiled, vsr

    def grads(state):
        return [p.grad.detach().clone() for p in vsr.param_leaves(state.params)]

    def params(state):
        return torch.cat([p.detach().flatten().double() for p in vsr.param_leaves(state.params)])

    with deterministic_algorithms():
        fn = make()
        route = "whole body" if isinstance(fn, compiled.TrainStepCache) else "segments"
        g = fresh(torch.float32)
        start = state_snapshot(g)
        for _ in range(2):
            fn(g, lr, gt)
        load_in_place(g, start)
        e = fresh(torch.float32)
        e2 = e if route == "whole body" else fresh(torch.float32)
        init = params(e)
        logs_equal, grads_equal, first_rel = True, True, None
        for i in range(steps):
            want, got = fn.eager(e, lr, gt)[1], fn(g, lr, gt)[1]
            if e2 is not e:
                fn.eager(e2, lr, gt)
            logs_equal &= all(torch.equal(got[k], want[k]) for k in want)
            rel = leaf_rel_errs(grads(g), grads(e))
            grads_equal &= max(rel) == 0.0
            first_rel = max(rel) if first_rel is None else first_rel
        torch.cuda.synchronize()
        res = {"route": route, "steps": steps, "signatures": fn.num_signatures, "graphs": fn.num_graphs,
               "bit_identical": bool(logs_equal and grads_equal and g.step == e.step and all(
                   torch.equal(a, b) for a, b in zip(state_snapshot(g), state_snapshot(e)))),
               "first_step_grad_rel_err_max": first_rel,
               "params_graphs_vs_eager": float((params(g) - params(e)).norm() / (params(e) - init).norm()),
               "params_eager_vs_eager": None if e2 is e else float(
                   (params(e2) - params(e)).norm() / (params(e) - init).norm())}
    del fn, g, e, e2
    torch.cuda.empty_cache()
    return res


def busy_ms(call) -> dict:
    """The device time of one call(): the union of its kernels' intervals
    on each device (kernels that overlap count once), from the profiler
    (CUPTI), in ms by device index."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    out = {}
    for dev, iv in spans.items():
        iv.sort()
        total, (lo, hi) = 0.0, iv[0]
        for a, b in iv[1:]:
            if a > hi:
                total, lo, hi = total + hi - lo, a, b
            else:
                hi = max(hi, b)
        out[dev] = (total + hi - lo) / 1e3
    return out


def time_sharded_routes(step, sharded, fresh, lr: torch.Tensor, gt: torch.Tensor, iters: int = 4) -> dict:
    """ms a float32 step of four routes, each on a fresh state: the
    single-device step eager and through its TrainStepCache, and the
    sharded step eager (`sharded.eager`) and compiled (`sharded`), the
    compiled ones after their warm-up and capture, so that only replays
    are timed: `iters` synchronised steps (medians; the compiled routes
    1.5x as many), the host ms until a call returns on an idle device;
    for the compiled routes the device's busy ms of one step (busy_ms,
    each card's) and the idle share 1 - busy / step.  Memory: the peak
    above the state's of the warm-up and capture (or the first eager
    step), the memory the graphs' pools keep after them, and the peak of
    the timed steps."""
    from sharkshark_tpu_torch.train import compiled

    routes = {"one_eager": step, "one_graphs": compiled.TrainStepCache(step), "sharded_eager": sharded.eager,
              "sharded_graphs": sharded}
    res = {}
    for name in list(routes):
        fn = routes.pop(name)
        graphs = name.endswith("graphs")
        state = fresh(torch.float32)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        for _ in range(2 if graphs else 1):
            fn(state, lr, gt)
        torch.cuda.synchronize()
        first_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        torch.cuda.empty_cache()
        pool = (torch.cuda.memory_reserved() - reserved) / 1e9
        torch.cuda.reset_peak_memory_stats()
        times, host = [], []
        for _ in range(iters * 3 // 2 if graphs else iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, lr, gt)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
        ms = statistics.median(times)
        row = {"ms": ms, "ms_min": min(times), "ms_max": max(times), "host_ms": statistics.median(host),
               "first_peak_gb": first_peak, "pool_gb": pool,
               "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9, "graphs": getattr(fn, "num_graphs", 0)}
        if graphs:
            busy = busy_ms(lambda: fn(state, lr, gt))
            row.update(busy_ms=busy, idle_share={d: 1.0 - b / ms for d, b in busy.items()})
        res[name] = row
        del fn, state
    torch.cuda.empty_cache()
    return res


def run_sharded_train(card: str) -> list[dict]:
    """configs/egvsr_bd.yml's FRNet (nf 64, nb 10, BD) from the minted
    weights (the seeded init diverges over the clip, PERF.md), T = 10:
    its own crop 128 and batch 4 on a data 2 x spatial 2 mesh (every band
    the whole 32-column clip), and crop 1024, batch 2 on spatial 2 (bands
    of 224 of the 256 LR columns), each against the single-device step.
    Float64 holds the CPU tests' tolerances (loss 1e-5, every leaf 1e-4).
    Float32 holds the loss at 1e-5 and each leaf at 1e-4 against the
    plain step, save a leaf where the plain step's own arithmetic, its
    loss summed in the mesh's order (mesh_order_grads), strays at least
    half as far from the plain step and the sharded step lies within
    1e-4 of that reading: rounding of the summation order, not of the
    sharding.  The compiled sharded step equals its eager step bit for
    bit on one card; across cards its first step's leaves lie within
    1e-5 of the eager step's."""
    import yaml
    from sharkshark_tpu_torch.models import egvsr, torch_import
    from sharkshark_tpu_torch.train import driver

    opt = yaml.safe_load((ROOT / "configs" / "egvsr_bd.yml").read_text())
    cfg = driver.build_training(opt, "cpu").cfg
    params = egvsr.from_torch(torch_import.load_state_dict(str(MINTED / "egvsr-derived-x4.pth")), cfg.model_cfg)
    rows = []
    own = opt["dataset"]["train"]
    for crop, batch, data, spatial in ((own["crop_size"], own["batch_size"], 2, 2), (1024, 2, 1, 2)):
        r = sharded_train_case(cfg, lambda s: cfg.lr, params, crop, batch, data, spatial,
                               t=opt["train"]["tempo_extent"])
        same, tm = r["graphs_vs_eager"], r["timing"]
        log(f"sharded train step, FRNet nf {cfg.model_cfg.nf} nb {cfg.model_cfg.nb}, crop {crop}, batch {batch}, "
            f"T {r['t']}, data {data} x spatial {spatial} on {r['devices']} ({r['route']}; bands [lo, c0, c1, hi] "
            f"{r['bands_lr_cols']}), compiled, against one device's compiled step: float32 loss rel err "
            f"{r['loss_rel_err']['l_total']:.3g}, "
            f"max ||d||/||g|| {r['grad_rel_err_max']:.3g} over {r['grad_leaves']} leaves (worst [leaf, err, float32 "
            f"floor, mesh-order reading vs one device, sharded vs the reading]: {r['worst_leaves']}; over 1e-4: "
            f"{r['leaves_over_1e-4']}; the reading vs one device {r['mesh_order_rel_err_max']:.3g}, sharded vs the "
            f"reading {r['vs_mesh_order_rel_err_max']:.3g}); float64 loss {r['float64_loss_rel_err']['l_total']:.3g}, "
            f"grads {r['float64_grad_rel_err_max']:.3g}; [signatures, graphs] of the compared steps "
            f"{r['compared_graphs']}; on {card}")
        log(f"  compiled vs eager sharded step, deterministic, {same['steps']} replays: bit identical "
            f"{same['bit_identical']}, first step's max leaf err {same['first_step_grad_rel_err_max']:.3g}, "
            f"params graphs vs eager {same['params_graphs_vs_eager']:.3g} (eager vs eager, across cards: "
            f"{same['params_eager_vs_eager']}), {same['graphs']} graphs")
        for name, x in tm.items():
            busy = (f", busy {', '.join(f'{v:.3f}' for v in x['busy_ms'].values())} ms, idle "
                    f"{', '.join(f'{v:.3f}' for v in x['idle_share'].values())}" if "busy_ms" in x else "")
            log(f"  {name}: {x['ms']:.3f} ms a step ({x['ms_min']:.3f}-{x['ms_max']:.3f}), host {x['host_ms']:.3f} "
                f"ms a call{busy}, graphs {x['graphs']}, first-call peak {x['first_peak_gb']:.3f} GB, pool "
                f"{x['pool_gb']:.3f} GB, peak {x['peak_gb']:.3f} GB")
        log(f"  wall s: {r['wall_s']}")
        assert max(r["float64_loss_rel_err"].values()) <= 1e-5 and r["float64_grad_rel_err_max"] <= 1e-4, r
        assert max(r["loss_rel_err"].values()) <= 1e-5 and not r["leaves_over_bound"], r
        assert all(g >= 1 for _, g in r["compared_graphs"].values()), r["compared_graphs"]
        if same["route"] == "whole body":
            assert same["bit_identical"] and same["graphs"] == 1, same
        else:
            assert same["first_step_grad_rel_err_max"] <= 1e-5, same
        rows.append(r)
    return rows


def run_warp_fidelity(counters, bench_warp, card: str) -> dict:
    """tools/warp_fidelity.py at its defaults (a seeded still at
    2160x3840, flows of 4, 20 and 90 px): its three rows, each within
    K3's tolerance of phase 3 against the float32 gather, and one K3
    launch a row."""
    from sharkshark_tpu_torch.tools import warp_fidelity

    counters.reset()
    t0 = time.perf_counter()
    rows = warp_fidelity.run([])
    wall = time.perf_counter() - t0
    launches = counters.read()
    log(f"warp_fidelity at 2160x3840: {rows}; launches {launches}; {wall:.3f} s on {card}")
    assert launches == {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": len(rows), "fused_conv_stack": 0}, launches
    assert all(r["max_abs_err"] <= bench_warp.TOL for r in rows), rows
    return {"rows": rows, "launches": launches, "wall_s": wall}


def run_other_tools(counters, card: str, tmp: Path) -> dict:
    """tools/ingest_weights.py on the minted SRVGG file (installed byte for
    byte under the zoo's name) and on two corrupted copies (truncated, and
    a tensor of the wrong shape), each refused with nothing copied;
    tools/bench_matrix.py --configs 3,0 --suites sr denoise --iters 2;
    tools/mint_lpips.py's training for 40 steps on its seeded stills, its
    export into `tmp` and its ranking check, on the card and the CPU (the
    committed pair untouched)."""
    from sharkshark_tpu_torch.tools import bench_matrix, ingest_weights, mint_lpips

    res = {}
    src = MINTED / "srvgg-derived-x4.pth"
    dst = Path(ingest_weights.main([str(src), "--model", "realesr-general-x4v3", "--weight-dir", str(tmp / "w")]))
    assert dst.name == "realesr-general-x4v3.pth" and dst.read_bytes() == src.read_bytes(), dst
    sd = torch.load(src, map_location="cpu", weights_only=True)
    inner = sd["params"]  # the release files' wrapper
    key = sorted(inner)[0]
    inner[key] = torch.zeros(tuple(v + 1 for v in inner[key].shape))
    bad = {"truncated": tmp / "truncated.pth", "misshaped": tmp / "misshaped.pth"}
    bad["truncated"].write_bytes(src.read_bytes()[: src.stat().st_size // 2])
    torch.save(sd, bad["misshaped"])
    res["ingest"] = {"installed": dst.name, "refused": {}}
    for name, path in bad.items():
        wdir = tmp / f"w_{name}"
        try:
            ingest_weights.main([str(path), "--model", "realesr-general-x4v3", "--weight-dir", str(wdir)])
        except (RuntimeError, KeyError, ValueError, SystemExit) as ex:
            res["ingest"]["refused"][name] = f"{type(ex).__name__}: {str(ex)[:160]}"
        assert name in res["ingest"]["refused"], f"ingest_weights accepted a {name} copy"
        assert not wdir.exists() or not list(wdir.iterdir()), f"a {name} copy was installed"
    log(f"ingest_weights: installed {dst.name} byte for byte; refused {res['ingest']['refused']}")

    counters.reset()
    t0 = time.perf_counter()
    rows = bench_matrix.run(["--configs", "3,0", "--suites", "sr", "denoise", "--iters", "2"])
    res["bench_matrix"] = {"rows": rows, "launches": counters.read(), "wall_s": time.perf_counter() - t0}
    sr, den = rows
    assert sr["fused_epilogue"] == "2/1" and sr["card"] == card and den["card"] == card, rows
    assert all(np.isfinite(r["fps"]) and r["fps"] > 0 for r in rows), rows
    log(f"bench_matrix: {rows}; launches {res['bench_matrix']['launches']}")

    # mint_lpips: its training on the card, its export and its ranking
    # check through train/metrics.LPIPS on the card, and the same check of
    # the same files on the CPU.  Its gate (every family ranked, the tool's
    # condition to ship) is printed, not asserted: after 40 steps on seeded
    # stills it passes or fails with the rounding of the run (PERF.md)
    t0 = time.perf_counter()
    stills, hold = mint_lpips.stills(None, None, str(tmp))
    params, losses = mint_lpips.train(stills, 40, device="cuda")
    (tmp / "lpips").mkdir()
    alex, lin = mint_lpips.export(params, str(tmp / "lpips"))
    check = mint_lpips.check_ranking(mint_lpips.LPIPS(alex, lin, "cuda"), hold)
    wall = time.perf_counter() - t0
    cpu = mint_lpips.check_ranking(mint_lpips.LPIPS(alex, lin, "cpu"), hold)
    dist_err = max(abs(a - b) / max(abs(b), 1e-3) for f in check["families"]
                   for a, b in zip(check["families"][f]["distances"], cpu["families"][f]["distances"]))
    res["mint_lpips"] = {"losses": losses, "check": check, "check_cpu": cpu, "card_vs_cpu_rel_err": dist_err,
                         "wall_s": wall}
    log(f"mint_lpips, 40 steps on seeded stills: loss {losses[0]:.4f} -> {losses[-1]:.4f}, ranking check on the "
        f"card {check} (gate {'passed' if check['ok'] else 'failed: the tool would not ship'}), the same files' "
        f"distances on the CPU within {dist_err:.3g} (relative, floor 1e-3); {wall:.3f} s on {card}")
    assert all(np.isfinite(losses)) and check["self_distance"] == 0.0, check
    assert dist_err <= 1e-3, (check, cpu)
    return res


def run_train_tools_phase(counters, bench_warp, card: str) -> dict:
    """Phase 16: make_sharded_train_step at full width, warp_fidelity on K3
    and the other three tools."""
    t_phase = time.perf_counter()
    res = {"sharded_train": run_sharded_train(card), "warp_fidelity": run_warp_fidelity(counters, bench_warp, card)}
    build = ROOT / "sharkshark_tpu_torch" / "build"
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        res["tools"] = run_other_tools(counters, card, Path(tmp))
    res["wall_s"] = time.perf_counter() - t_phase
    return res


# -------------------------------------------------------------- phase 17


def graph_counts(svc) -> dict:
    """Signatures seen and graphs held by each of a service's ShapeCaches."""
    from sharkshark_tpu_torch.upscale import ShapeCache

    out = {}
    for name in ("_cold_step", "_warm_step", "_flush_step", "_multi_step", "_step", "_chunk_step"):
        cache = getattr(svc, name, None)
        if isinstance(cache, ShapeCache):
            out[name.strip("_")] = {"signatures": cache.num_signatures, "graphs": cache.num_graphs}
    return out


def assert_graphs_freed() -> None:
    """The services dropped so far must have freed their graphs without
    the cycle collector (by reference counting, or by close()): collect
    what it finds unreachable, and fail if a ShapeCache that holds a
    graph is among it."""
    from sharkshark_tpu_torch.upscale import ShapeCache

    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        held = sum(o.num_graphs for o in gc.garbage if isinstance(o, ShapeCache))
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.collect()
    assert not held, f"dropped services kept {held} graphs alive in reference cycles"


def hold_equal(what: str, got: np.ndarray, want: np.ndarray, floor: float = 55.0) -> dict:
    """Outputs through the graphs against the eager steps': identical, or
    (a finding for PERF.md) at least `floor` dB."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, (got.shape, want.shape)
    if np.array_equal(got, want):
        res = {"identical": True, "differing_values": 0, "max_abs_diff": 0, "psnr_db": float("inf")}
    else:
        res = {"identical": False, "differing_values": int((got != want).sum()),
               "max_abs_diff": int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()),
               "psnr_db": psnr(got, want)}
    log(f"{what}: through the graphs against the eager steps "
        f"{'identical bit for bit' if res['identical'] else 'DIFFERENT'} ({res['differing_values']} values "
        f"differ, max {res['max_abs_diff']}, PSNR {res['psnr_db']:.3f} dB)")
    assert res["identical"] or res["psnr_db"] >= floor, f"{what}: PSNR {res['psnr_db']:.3f} dB below {floor}"
    return res


def back_to_back_ms(call, n: int = 6) -> float:
    """Device ms of one call: n calls back to back between two CUDA events,
    after two calls that put the device ahead of the host (both the eager
    steps and the replays enqueue a step faster than the card runs it)."""
    call()
    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def step_ms(eager, replay) -> dict:
    """back_to_back_ms of the eager step and of its replay, in passes
    eager, replay, replay, eager."""
    passes = {"eager": [], "replay": []}
    for name in ("eager", "replay", "replay", "eager"):
        passes[name].append(back_to_back_ms(eager if name == "eager" else replay))
    return passes


def timing_row(eager_host: tuple, replay_host: tuple, passes: dict, frames_per_call: int) -> dict:
    """Host ms a dispatch and of the step's calls in it (medians, one
    dispatch at a time on an idle device; eager_dispatches' and
    service_sync's pairs) and the step's device ms/frame (the mean of
    step_ms's two passes each), eager and replayed."""
    eager_ms, replay_ms = (statistics.mean(passes[k]) for k in ("eager", "replay"))
    row = {"host_ms_per_dispatch_eager": statistics.median(eager_host[0]),
           "host_ms_per_dispatch_replay": statistics.median(replay_host[0]),
           "step_host_ms_per_dispatch_eager": statistics.median(eager_host[1]),
           "step_host_ms_per_dispatch_replay": statistics.median(replay_host[1]),
           "host_ms_eager_all": eager_host[0], "host_ms_replay_all": replay_host[0],
           "device_ms_per_frame_eager": eager_ms / frames_per_call,
           "device_ms_per_frame_replay": replay_ms / frames_per_call, "device_ms_passes": passes}
    row["device_replay_over_eager"] = replay_ms / eager_ms
    return row


def timing_text(row: dict) -> str:
    return (f"host ms a dispatch eager {row['host_ms_per_dispatch_eager']:.3f} / replay "
            f"{row['host_ms_per_dispatch_replay']:.3f} (its step calls {row['step_host_ms_per_dispatch_eager']:.3f} / "
            f"{row['step_host_ms_per_dispatch_replay']:.3f}); device ms/frame of the step eager "
            f"{row['device_ms_per_frame_eager']:.4f} / replay {row['device_ms_per_frame_replay']:.4f} "
            f"(x{row['device_replay_over_eager']:.4f})")


def eager_dispatches(step, frames: np.ndarray, batch: int, dev) -> tuple[list, tuple]:
    """`step(frames on the device)` for each micro-batch, uploaded and its
    result copied to the host as the service's dispatch does, one at a time
    on an idle device: (host arrays, (host ms a dispatch, host ms of the
    step's call)).  Each result is copied out of its pinned buffer, so
    that the buffers recycle as they do behind a live stream."""
    from sharkshark_tpu_torch.upscale import service as service_mod

    outs, host, host_step = [], [], []
    with torch.inference_mode():
        for i in range(0, len(frames), batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = service_mod._to_device(dev, frames[i : i + batch])
            t1 = time.perf_counter()
            out = step(x)
            host_step.append((time.perf_counter() - t1) * 1e3)
            copy = service_mod._HostCopy(out)
            host.append((time.perf_counter() - t0) * 1e3)
            outs.append(copy.numpy().copy())
            del copy, out
    return outs, (host, host_step)


def service_sync(svc, counters, frames: np.ndarray, batch: int, step_name: str):
    """One stream through a service, one dispatch at a time on an idle
    device (each result copied out of its pinned buffer, as in
    eager_dispatches), then its drain.  Returns (frames out, (host ms a
    dispatch, host ms of its calls of the cache `step_name`), launches a
    dispatch)."""
    cache, in_step = getattr(svc, step_name), [0.0]

    def timed(*args):
        t0 = time.perf_counter()
        out = cache(*args)
        in_step[0] += (time.perf_counter() - t0) * 1e3
        return out

    setattr(svc, step_name, timed)
    host, host_step, launches, outs = [], [], [], []
    try:
        for i in range(0, len(frames), batch):
            before = counters.read()
            in_step[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev, n = svc.upscale_dispatch(frames[i : i + batch])
            host.append((time.perf_counter() - t0) * 1e3)
            host_step.append(in_step[0])
            outs.append(svc._fetch(dev, n).copy())
            del dev
            launches.append({k: v - before[k] for k, v in counters.read().items()})
        outs += [np.asarray(e.frames) for e in svc.proc_eof()]
    finally:
        setattr(svc, step_name, cache)
    return np.concatenate(outs), (host, host_step), launches


def drive_counted(svc, counters, jobs: list):
    """drive() with the launches of each dispatch read around it."""
    from sharkshark_tpu_torch.upscale import service as service_mod

    per_dispatch = []
    orig = svc.upscale_dispatch

    def counting(frames):
        before = counters.read()
        out = orig(frames)
        per_dispatch.append({k: v - before[k] for k, v in counters.read().items()})
        return out

    svc.upscale_dispatch = counting
    try:
        got, stamps, _ = drive(svc, service_mod.UpscalerQueueEntry, jobs)
    finally:
        del svc.upscale_dispatch
    return np.concatenate([np.asarray(e.frames) for e in got]), stamps, per_dispatch


def run_graph_denoise(counters, card: str, defaults: dict, n: int = 48) -> dict:
    """The main path's service (its defaults, 720p -> 1440p, BSVD-32 and
    SRVGG general-x4v3 minted, bf16) over n frames and the drain, through
    its graphs, held against the eager steps (steps.upscale_batch_denoise,
    warm chunks in place, ring_to_fifo_state, steps.flush_batch_denoise)
    driven the same way on the same weights.  Micro-batch 4: driven as the
    live pipeline drives it (launches a dispatch, delivered ms/frame), then
    a second stream after reset_stream one dispatch at a time (host ms a
    dispatch, eager against replay); the warm step holds two graphs.
    Micro-batch 8 (SR in sub-batches of 4): stream 1 one dispatch at a
    time too; the warm step holds one graph.  Then the warm step alone,
    eager and replayed, back to back on frames already on the card."""
    from sharkshark_tpu_torch.models import bsvd, srvgg
    from sharkshark_tpu_torch.upscale import service as service_mod
    from sharkshark_tpu_torch.upscale import steps

    res = {}
    frames = make_frames(n, 720, 1280, seed=71, pan=2)
    for batch in (4, 8):
        svc = service_mod.EsrganUpscalerService(
            lr_level=3, output_shape=(1440, 2560), denoising=True, denoise_rate=0.75, batch_size=batch,
            weights=str(MINTED / "srvgg-derived-x4.pth"), denoise_weights=str(MINTED / "bsvd-derived-32.pth"),
            **defaults)
        svc.proc_init()
        spec, cfg, sub = svc.spec, svc.bsvd_cfg, 4 if batch > 4 else None

        def sr_apply(p, x):
            return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=svc.conv_stack)

        def step(x, box):
            st = box["state"]
            out, box["state"] = steps.upscale_batch_denoise(sr_apply, svc._params, st, x, spec, cfg,
                                                            warm=st["t"] >= bsvd.SHIFT_NUM, sr_sub_batch=sub,
                                                            inplace=True)
            return out

        box = {"state": steps.init_denoise_state(1, spec, cfg, device=svc.device)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs, eager_host = eager_dispatches(lambda x: step(x, box), frames, batch, svc.device)
        with torch.inference_mode():
            box["state"] = bsvd.ring_to_fifo_state(box["state"], cfg)

        def flush(x):
            out, box["state"] = steps.flush_batch_denoise(sr_apply, svc._params, box["state"], x, n, spec, cfg)
            return out

        outs += eager_dispatches(flush, frames[-bsvd.SHIFT_NUM :], batch, svc.device)[0]
        eager_out = np.concatenate(outs)
        row = {"batch": batch, "frames": n, "eager_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        cold, jobs = bsvd.SHIFT_NUM // batch, n // batch
        per_chunk = {"tsm_conv": 16, "tsm_conv_pair": 0, "backward_warp": 0,
                     "fused_conv_stack": 32 * (batch // 4) if defaults["conv_stack"] else 0}
        torch.cuda.reset_peak_memory_stats()
        if batch == 4:
            # stream 1 as the live pipeline drives it
            counters.reset()
            stream1, stamps, per_dispatch = drive_counted(svc, counters, [frames[i : i + batch]
                                                                          for i in range(0, n, batch)])
            total = counters.read()
            want = denoise_launches(cold, jobs - cold, bsvd.SHIFT_NUM // batch, defaults["tsm_pair"],
                                    defaults["conv_stack"])
            assert total == want, f"denoise service through its graphs: launches {total}, expected {want}"
            assert all(d == per_chunk for d in per_dispatch), f"launches a dispatch: {per_dispatch}"
            row["stream1"] = hold_equal(f"denoise service, micro-batch {batch}, stream 1", stream1, eager_out)
            # each ring phase's warm step runs eagerly once, is captured at
            # its second call and replays after
            first_replay = cold + 2 * (8 // batch)
            row["delivered_ms_per_frame_replay"] = ((stamps[jobs - 1] - stamps[first_replay - 1])
                                                    / ((jobs - first_replay) * batch) * 1e3)
            row["launches"], row["launches_per_dispatch"] = total, per_dispatch[-1]
        else:
            # stream 1 one dispatch at a time
            stream1, _, per_dispatch = service_sync(svc, counters, frames, batch, "_warm_step")
            assert all(d == per_chunk for d in per_dispatch), f"launches a dispatch: {per_dispatch}"
            row["stream1"] = hold_equal(f"denoise service, micro-batch {batch}, stream 1", stream1, eager_out)
        # stream 2, whose warm dispatches all replay
        svc.reset_stream()
        out2, host2, launches2 = service_sync(svc, counters, frames, batch, "_warm_step")
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        assert all(d == per_chunk for d in launches2), f"launches a dispatch: {launches2}"
        row["stream2"] = hold_equal(f"denoise service, micro-batch {batch}, stream 2 after reset_stream", out2,
                                    eager_out)
        assert np.array_equal(out2, stream1), "the second stream differs from the first"
        row["graphs"] = graph_counts(svc)
        assert row["graphs"]["warm_step"]["graphs"] == 8 // batch, row["graphs"]
        # the warm step alone, on frames already on the card: eager on a
        # fresh state taken past its cold chunks, the graphs on the
        # service's (its values the drained stream's; the work is the same)
        with torch.inference_mode():
            x_dev = service_mod._to_device(svc.device, frames[:batch])
            warm_box = {"state": steps.init_denoise_state(1, spec, cfg, device=svc.device)}
            while warm_box["state"]["t"] < bsvd.SHIFT_NUM:
                step(x_dev, warm_box)
            passes = step_ms(lambda: step(x_dev, warm_box),
                             lambda: svc._den_call(svc._warm_step, x_dev, svc._warm_t(batch)))
        row.update(timing_row(tuple(v[cold:] for v in eager_host), tuple(v[cold:] for v in host2), passes, batch))
        res[f"batch{batch}"] = row
        log(f"denoise service through its graphs, micro-batch {batch}, {n} frames + drain: graphs "
            f"{row['graphs']}; warm dispatches: {timing_text(row)}"
            + (f"; delivered {row['delivered_ms_per_frame_replay']:.3f} ms/frame over the replays" if batch == 4
               else "")
            + f"; peak memory eager {row['eager_peak_mem_gb']:.3f} GB, graphs {row['peak_mem_gb']:.3f} GB on {card}")
        svc.close()
        del svc, box, warm_box, x_dev
    return res


def run_graph_sr(counters, card: str, conv_stack: int, jobs: int = 8, batch: int = 4) -> dict:
    """The SR-only service (minted SRVGG, conv_stack as the main path's) at
    720p -> 1440p over `jobs` micro-batches through its graph, held the
    same way against steps.upscale_multi: as the live pipeline drives it,
    then a second pass one dispatch at a time; then the step alone, eager
    and replayed, back to back."""
    from sharkshark_tpu_torch.models import srvgg
    from sharkshark_tpu_torch.upscale import service as service_mod
    from sharkshark_tpu_torch.upscale import steps

    svc = service_mod.EsrganUpscalerService(lr_level=3, output_shape=(1440, 2560), denoising=False, batch_size=batch,
                                            weights=str(MINTED / "srvgg-derived-x4.pth"), conv_stack=conv_stack)
    svc.proc_init()
    frames = make_frames(jobs * batch, 720, 1280, seed=73)

    def step(x):
        return steps.upscale_multi(lambda p, y: srvgg.apply_down_rational(p, y, 2, 1, conv_stack=svc.conv_stack),
                                   svc._sr_params, x, svc.spec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, eager_host = eager_dispatches(step, frames, batch, svc.device)
    eager_out = np.concatenate(outs)
    row = {"batch": batch, "frames": jobs * batch, "eager_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out1, stamps, per_dispatch = drive_counted(svc, counters, [frames[i : i + batch]
                                                               for i in range(0, len(frames), batch)])
    want = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": 0, "fused_conv_stack": 32}
    assert all(d == want for d in per_dispatch), f"SR-only launches a dispatch: {per_dispatch}"
    row["stream1"] = hold_equal("SR-only service, pass 1", out1, eager_out)
    # job 0 runs eagerly, job 1 is captured, the rest replay
    row["delivered_ms_per_frame_replay"] = (stamps[-1] - stamps[1]) / ((jobs - 2) * batch) * 1e3
    out2, host2, _ = service_sync(svc, counters, frames, batch, "_multi_step")
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["stream2"] = hold_equal("SR-only service, pass 2", out2, eager_out)
    row["graphs"] = graph_counts(svc)
    assert row["graphs"]["multi_step"] == {"signatures": 1, "graphs": 1}, row["graphs"]
    with torch.inference_mode():
        x_dev = service_mod._to_device(svc.device, frames[:batch])
        passes = step_ms(lambda: step(x_dev), lambda: svc._multi_step(svc._sr_params, x_dev))
    row.update(timing_row(eager_host, host2, passes, batch))
    log(f"SR-only service through its graph, {jobs} jobs of {batch}: graphs {row['graphs']}; {timing_text(row)}; "
        f"delivered {row['delivered_ms_per_frame_replay']:.3f} ms/frame "
        f"over the replays; peak memory eager {row['eager_peak_mem_gb']:.3f} GB, graphs {row['peak_mem_gb']:.3f} GB "
        f"on {card}")
    svc.close()
    return row


def run_graph_egvsr(counters, card: str, chunked: bool, jobs: int = 6, batch: int = 4) -> dict:
    """The EGVSR service (minted FRNet, 720p -> 1440p, cut_threshold 0.12)
    per frame or chunked over phase 6's frames through its graph (one K3
    launch a frame), held the same way against steps.egvsr_upscale_step /
    egvsr_upscale_chunk: as the live pipeline drives it, then a second
    stream (the recurrent state zeroed) one dispatch at a time; then the
    step alone, eager and replayed, back to back."""
    from sharkshark_tpu_torch.models import egvsr
    from sharkshark_tpu_torch.upscale import service as service_mod
    from sharkshark_tpu_torch.upscale import steps

    route = "chunked" if chunked else "per-frame"
    svc = service_mod.EgvsrUpscalerService(lr_level=3, output_shape=(1440, 2560), chunked=chunked,
                                           weights=str(MINTED / "egvsr-derived-x4.pth"))
    svc.proc_init()
    frames = make_frames(jobs * batch, 720, 1280, seed=13)

    def fresh():
        return egvsr.init_recurrent_state(1, *svc.lr_shape, svc.cfg, svc.compute_dtype, svc.device)

    kw = dict(cut_threshold=svc.cut_threshold, cfg=svc.cfg)
    fn = steps.egvsr_upscale_chunk if chunked else steps.egvsr_upscale_step
    box = {"state": fresh()}

    def one(x):
        out, box["state"] = fn(svc._params, box["state"], x, svc.spec, **kw)
        return out

    def step(x):
        return one(x) if chunked else torch.cat([one(x[i : i + 1]) for i in range(len(x))])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, eager_host = eager_dispatches(step, frames, batch, svc.device)
    eager_out = np.concatenate(outs)
    row = {"route": route, "frames": jobs * batch, "eager_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out1, stamps, per_dispatch = drive_counted(svc, counters, [frames[i : i + batch]
                                                               for i in range(0, len(frames), batch)])
    want = {"tsm_conv": 0, "tsm_conv_pair": 0, "backward_warp": batch, "fused_conv_stack": 0}
    assert all(d == want for d in per_dispatch), f"EGVSR ({route}) launches a dispatch: {per_dispatch}"
    row["stream1"] = hold_equal(f"EGVSR service ({route}), stream 1", out1, eager_out)
    # per frame: frames 0 and 1 (job 0) run eagerly and are captured;
    # chunked: jobs 0 and 1
    first_replay = 2 if chunked else 1
    row["delivered_ms_per_frame_replay"] = ((stamps[-1] - stamps[first_replay - 1])
                                            / ((jobs - first_replay) * batch) * 1e3)
    svc.reset_stream()
    out2, host2, _ = service_sync(svc, counters, frames, batch, "_chunk_step" if chunked else "_step")
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["stream2"] = hold_equal(f"EGVSR service ({route}), stream 2", out2, eager_out)
    row["graphs"] = graph_counts(svc)
    name = "chunk_step" if chunked else "step"
    assert row["graphs"][name] == {"signatures": 1, "graphs": 1}, row["graphs"]
    cache = svc._chunk_step if chunked else svc._step
    with torch.inference_mode():
        x_dev = service_mod._to_device(svc.device, frames[:batch] if chunked else frames[:1])

        def replay():
            _, svc._state = cache(svc._params, svc._state, x_dev)

        passes = step_ms(lambda: one(x_dev), replay)
    row.update(timing_row(eager_host, host2, passes, batch if chunked else 1))
    log(f"EGVSR service ({route}) through its graph, {jobs * batch} frames: graphs {row['graphs']}; dispatches of "
        f"{batch} frames: {timing_text(row)}; delivered "
        f"{row['delivered_ms_per_frame_replay']:.3f} ms/frame over the replays; peak memory eager "
        f"{row['eager_peak_mem_gb']:.3f} GB, graphs {row['peak_mem_gb']:.3f} GB on {card}")
    svc.close()
    return row


def run_graph_phase(counters, card: str, defaults: dict) -> dict:
    """Phase 17: the single-device services' per-shape CUDA graphs."""
    t_phase = time.perf_counter()
    res, walls = {"card": card}, {}
    for name, run in (("denoise", lambda: run_graph_denoise(counters, card, defaults)),
                      ("sr_only", lambda: run_graph_sr(counters, card, defaults["conv_stack"])),
                      ("egvsr", lambda: run_graph_egvsr(counters, card, chunked=False)),
                      ("egvsr_chunked", lambda: run_graph_egvsr(counters, card, chunked=True))):
        t0 = time.perf_counter()
        res[name] = run()
        walls[name] = time.perf_counter() - t0
    res["wall_s"], res["wall_s_by_part"] = time.perf_counter() - t_phase, walls
    return res


def get_bytes(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()



def kernel_entry(bench, name: str, source: str, replaces: str, launches: int, rows: list[dict]) -> dict:
    """One kernel of the `kernels` line: per launch, averaged over `rows`
    (the shapes the path gives it), with the bound of that same work.
    `ms` and `library_ms` are device times of calls back to back (the
    host's work overlapped), `call_ms` and `library_call_ms` the time
    around one call (its host work included where the device waits for
    it), `plain_ms` around one call."""
    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    b = bench.bound(sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows),
                    rows[0].get("peak_flops", bench.PEAK_BF16_FLOPS))
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("device_ms"), "call_ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": b["bound_ms"] / len(rows), "bound_by": b["bound_by"], "library_ms": mean("library_device_ms"),
        "library_call_ms": mean("library_ms"),
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

    if "--train-only" in sys.argv[1:]:
        build = ROOT / "sharkshark_tpu_torch" / "build"
        build.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            train_res = run_training_phase(counters, card, Path(tmp))
            log(f"phase 12 took {train_res['wall_s']:.1f} s")
            gan_res = run_gan_phase(counters, card, Path(tmp))
            log(f"phase 13 took {gan_res['wall_s']:.1f} s")
        log(json.dumps({"training": train_res, "gan_variants_tools": gan_res}))
        log(card)
        return 0

    if "--mesh-only" in sys.argv[1:]:
        egvsr_res, egvsr_out = run_egvsr_path(service_mod, counters, card)
        mesh_res = run_mesh_phase(service_mod, counters, tsm, cs, bench, bench_cs, bench_warp, card, defaults,
                                  egvsr_res, egvsr_out)
        log(f"phase 15 took {mesh_res['wall_s']:.1f} s")
        t_phase = time.perf_counter()
        train_rows = run_sharded_train(card)
        log(f"phase 16's sharded train step took {time.perf_counter() - t_phase:.1f} s")
        log(json.dumps({"mesh": mesh_res, "sharded_train": train_rows}))
        log(card)
        return 0

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
    cli_res = run_cli(counters, card, main_cli_runs(defaults))
    e2e_rows = run_bench_e2e(card)

    # 9. the SR-only service, coalesced requests, tiled upscale (K4's paths)
    sr_res = run_sr_path(service_mod, counters, card, stack_l)
    sr_res["layer_by_layer"] = run_sr_path(service_mod, counters, card, 0)
    coalesce_res = run_coalesced_requests(service_mod, counters, card, stack_l)
    tile_res = run_tile_upscale(counters, card, cs.L_MAX)

    # 10. the model zoo and the other entry points
    t0 = time.perf_counter()
    zoo_res = run_zoo_phase(service_mod, counters, bench, card)
    zoo_res["wall_s"] = time.perf_counter() - t0
    log(f"phase 10 took {zoo_res['wall_s']:.1f} s")

    # 11. the HTTP image service on the card
    image_res = run_image_service(counters, card)
    log(f"phase 11 took {image_res['wall_s']:.1f} s")
    log(json.dumps({"image_service": image_res}))

    assert_graphs_freed()
    # 12. the training driver's three recipes on the card, then 13. the
    # GAN recipe, the variants and the tools, in one temporary directory:
    # phase 13 derives its data from phase 12's stills and exports its
    # checkpoints
    build = ROOT / "sharkshark_tpu_torch" / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        train_res = run_training_phase(counters, card, Path(tmp))
        log(f"phase 12 took {train_res['wall_s']:.1f} s")
        log(json.dumps({"training": train_res}))
        gan_res = run_gan_phase(counters, card, Path(tmp))
        log(f"phase 13 took {gan_res['wall_s']:.1f} s")
        log(json.dumps({"gan_variants_tools": gan_res}))

    assert_graphs_freed()
    # 14. BSVD-64 through the service (K1 at C=128, 360x640), the
    # per-frame denoise stream, SRVGG's integer-ratio epilogues and the
    # exported programs
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        bsvd64_res = run_bsvd64_phase(service_mod, counters, bench, tsm, card, main_out, Path(tmp))
    log(f"phase 14 took {bsvd64_res['wall_s']:.1f} s")
    log(json.dumps({"bsvd64_single_epilogues_export": bsvd64_res}))

    assert_graphs_freed()
    # 15. the sharded serving paths (parallel/): the denoise, SR-only and
    # EGVSR services on meshes, the CLI with --mesh, K1 and K4 on each card
    mesh_res = run_mesh_phase(service_mod, counters, tsm, cs, bench, bench_cs, bench_warp, card, defaults,
                              egvsr_res, egvsr_out)
    log(f"phase 15 took {mesh_res['wall_s']:.1f} s")
    log(json.dumps({"mesh": mesh_res}))

    assert_graphs_freed()
    # 16. the sharded train step at full width, warp_fidelity on K3 and
    # the other tools
    tools_res = run_train_tools_phase(counters, bench_warp, card)
    log(f"phase 16 took {tools_res['wall_s']:.1f} s")
    log(json.dumps({"train_tools": tools_res}))

    assert_graphs_freed()
    # 17. the single-device services' per-shape CUDA graphs against the
    # eager steps
    graph_res = run_graph_phase(counters, card, defaults)
    log(f"phase 17 took {graph_res['wall_s']:.1f} s")
    log(json.dumps({"graphs": graph_res}))

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
    kernels[2]["cases"] = warp_rows
    kernels[2]["max_abs_err"] = max(r["max_abs_err"] for r in warp_rows)
    kernels[3]["cases"] = stack_rows
    zoo_cli = zoo_res["cli"][0]["launches"]  # animevideov3 with the default denoise
    kernels[0]["launches_zoo_cli"] = zoo_cli["tsm_conv"]
    # K1 at BSVD-64's C=128 shape, beside the main path's (the headline
    # numbers stay the main path's), with its launches on that path
    kernels[0]["shapes"].append({**bsvd64_res["k1_c128_360x640"], "path": "BSVD-64 service"})
    kernels[0]["launches_bsvd64"] = bsvd64_res["service"]["launches"]["tsm_conv"]
    kernels[3]["launches_zoo_cli"] = zoo_cli["fused_conv_stack"]
    kernels[3]["launches_image_service"] = image_res["k4_launches"]
    kernels[2]["launches_train_test"] = train_res["frnet"]["test_launches"]["backward_warp"]
    # FRNet's periodic tests in training, through one inference graph
    kernels[2]["launches_train_periodic_tests"] = train_res["frnet"]["train_launches"]["backward_warp"]
    kernels[2]["launches_gan_test"] = gan_res["gan"]["test"]["launches"]["backward_warp"]
    # the sharded paths of phase 15: every band's launches, by device too
    mesh_den = mesh_res["denoise"]["mesh"]
    kernels[0]["launches_sharded_denoise"] = mesh_den["launches"]["tsm_conv"]
    kernels[0]["launches_sharded_denoise_by_device"] = mesh_den["launches_by_device"]["tsm_conv"]
    kernels[3]["launches_sharded_denoise"] = mesh_den["launches"]["fused_conv_stack"]
    kernels[3]["launches_sharded_denoise_by_device"] = mesh_den["launches_by_device"]["fused_conv_stack"]
    kernels[3]["launches_sharded_sr"] = mesh_res["sr_only"]["mesh"]["launches"]["fused_conv_stack"]
    # one K3 launch a band and frame, through the bands' graphs; and K3 at
    # those bands
    kernels[2]["launches_sharded_egvsr"] = mesh_res["egvsr"]["mesh"]["launches"]["backward_warp"]
    kernels[2]["band_cases"] = mesh_res["band_kernels"]["backward_warp"]
    kernels[2]["launches_warp_fidelity"] = tools_res["warp_fidelity"]["launches"]["backward_warp"]
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} was not launched on its path"
    assert kernels[2]["launches_sharded_egvsr"] > 0, "K3 was not launched on the sharded EGVSR path"
    log(json.dumps({"defaults": defaults, "routes_on": routes_on, "route_timing": route_rows,
                    "main_path": main_res, "routes_on_path": on_res, "k1_layer_by_layer_path": ref_res,
                    "step_psnr_db": step_psnr, "egvsr_path": egvsr_res, "egvsr_chunked_path": chunk_res,
                    "egvsr_step_psnr_db": egvsr_psnr, "cli": cli_res, "bench_e2e": e2e_rows, "sr_path": sr_res,
                    "coalesced": coalesce_res, "tile": tile_res, "zoo": zoo_res, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
