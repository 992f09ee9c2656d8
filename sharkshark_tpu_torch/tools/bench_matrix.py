"""Throughput matrix across the resolution ladders, through the port's
services on one card (counterpart of the JAX package's
tools/bench_matrix.py).

    python -m sharkshark_tpu_torch.tools.bench_matrix [--configs 3,0 5,0 1,0]
        [--batch 4] [--iters 6] [--suites sr egvsr cuts denoise]
        [--egvsr-weights PATH] [--device cuda|cpu]

Suites, each printing the JAX tool's JSON rows, one a line, then every
row as one {"matrix": [...]} line:
- sr: EsrganUpscalerService with denoising off at each (lr_level,
  hr_level) of --configs, micro-batch --batch: frames/s, and the fused
  pixel-shuffle + bicubic epilogue that the service picks for the level
  (upscale/service.py::_fast_epilogue_ratio), as "num/den" or null;
- egvsr: EgvsrUpscalerService (seeded FRNet at egvsr.PRODUCTION, nb 10,
  BD) one frame a dispatch at LR levels 1-3, output 4x: ms a frame;
- cuts: the same service at LR level 3 over a stream of two panning
  scenes that switch every 24 frames, with the scene-cut skip at 0.12
  and off: sustained ms a frame and the p99 of single frames each
  waited for; then K3 alone on the 4x frame with a smooth flow and a
  rough one (the rows keep the JAX tool's names, egvsr-warp-fast and
  -full; the port's K3 has one route for both, "window": "single");
- denoise: EsrganUpscalerService with BSVD-32 denoise (seeded weights),
  LR level 3 -> 1440p, once its stream is warm: frames/s.
Each row carries the device and the card's name and power limit
(nvidia-smi; null on the CPU).  Frames are zeros, as the JAX tool's
are; weights are seeded (the rate does not depend on them).  Each suite
runs one call to warm up before its timed calls.

The JAX tool enables its persistent compilation cache first; the port
has nothing to enable: the kernels' on-disk build cache
(ops/_build.py::_lib_path, keyed by the source's hash) plays that part.
Computes in bf16 on the card and in float32 with `--device cpu` (the
tests); without it a host without CUDA raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models import egvsr
from ..ops.warp import backward_warp_fast
from ..upscale import levels
from ..upscale import service as service_mod
from ..utils import resolve_device
from .bench_e2e import card_line

__all__ = ["fused_ratio", "bench_sr", "bench_egvsr", "bench_cuts", "bench_denoise", "run", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dtype(dev: torch.device) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _row(row: dict, dev: torch.device, card: str | None) -> dict:
    row = {**row, "device": str(dev), "card": card}
    print(json.dumps(row), flush=True)
    return row


def fused_ratio(lr: tuple[int, int], hr: tuple[int, int]) -> str | None:
    """The fused epilogue's ratio the service picks for the level, as
    "num/den", or None where it runs the plain SRVGG apply."""
    r = service_mod._fast_epilogue_ratio(lr, hr)
    return None if r is None else f"{r[0]}/{r[1]}"


def _time_dispatches(svc, frames: np.ndarray, iters: int) -> float:
    """Seconds for `iters` dispatches of `frames`, the last one's host copy
    waited for."""
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = svc.upscale_dispatch(frames)
    svc._fetch(*out)
    return time.perf_counter() - t0


def bench_sr(configs: list[str], batch: int, iters: int, dev: torch.device, card: str | None) -> list[dict]:
    rows = []
    for pair in configs:
        lr_level, hr_level = (int(v) for v in pair.split(","))
        lr, hr = levels.LR_LEVELS[lr_level], levels.HR_LEVELS[hr_level]
        svc = service_mod.EsrganUpscalerService(lr_level=lr_level, output_shape=hr, denoising=False,
                                                batch_size=batch, compute_dtype=_dtype(dev), device=dev)
        svc.proc_init()
        frames = np.zeros((batch, *lr, 3), np.uint8)
        svc.upscale(frames)  # build and warm
        dt = _time_dispatches(svc, frames, iters)
        rows.append(_row({"lr_level": lr_level, "hr_level": hr_level, "lr": f"{lr[0]}x{lr[1]}",
                          "out": f"{hr[0]}x{hr[1]}", "fused_epilogue": fused_ratio(lr, hr),
                          "fps": round(iters * batch / dt, 2)}, dev, card))
    return rows


def _egvsr_service(dev, lr_level, weights=None, cut_threshold=None):
    svc = service_mod.EgvsrUpscalerService(
        lr_level=lr_level, output_shape=None, weights=weights, compute_dtype=_dtype(dev),
        cfg=None if weights else egvsr.PRODUCTION, cut_threshold=cut_threshold, device=dev)
    svc.proc_init()
    return svc


def bench_egvsr(iters: int, dev: torch.device, card: str | None) -> list[dict]:
    """The EGVSR ladder (the reference's egvsr_test.py shapes): one frame
    a dispatch, the recurrence carried."""
    rows = []
    for lr_level in (1, 2, 3):
        h, w = levels.LR_LEVELS[lr_level]
        svc = _egvsr_service(dev, lr_level)
        frame = np.zeros((1, h, w, 3), np.uint8)
        svc.upscale(frame)
        ms = _time_dispatches(svc, frame, iters) / iters * 1e3
        rows.append(_row({"model": "egvsr", "lr": f"{h}x{w}", "out": f"{h * 4}x{w * 4}",
                          "ms_per_frame": round(ms, 1), "fps": round(1000 / ms, 2)}, dev, card))
    return rows


def _scene_frames(h: int, w: int, cut_every: int) -> list[np.ndarray]:
    """Two panning scenes from two low-passed textures, switching every
    `cut_every` frames: smooth motion inside a scene (a 2-px pan leaves
    a small frame difference), a full-content switch at each cut."""
    import cv2

    rng = np.random.default_rng(7)
    tex = []
    for _ in range(2):
        t = rng.random((h + 64, w + 64, 3)).astype(np.float32)
        tex.append(cv2.GaussianBlur(t, (0, 0), 12) * 4.0 % 1.0)
    frames = []
    for i in range(max(2 * cut_every, 48)):
        off = (i % cut_every) * 2
        view = tex[(i // cut_every) % 2][off : off + h, off : off + w]
        frames.append(np.clip(view * 255 + 0.5, 0, 255).astype(np.uint8)[None])
    return frames


def bench_cuts(iters: int, dev: torch.device, card: str | None, cut_every: int = 24,
               weights: str | None = None) -> list[dict]:
    """Mixed-content EGVSR at LR level 3 with the scene-cut skip on
    (threshold 0.12) and off: sustained ms a frame and the p99 of single
    frames each waited for; then K3 alone on a smooth and a rough flow
    at the 4x frame."""
    h, w = levels.LR_LEVELS[3]
    frames = _scene_frames(h, w, cut_every)
    rows = []
    for thr in (0.12, None):
        svc = _egvsr_service(dev, 3, weights, thr)
        svc.upscale(frames[0])
        svc.upscale(frames[cut_every])
        svc = _egvsr_service(dev, 3, weights, thr)  # a fresh stream for the sustained pass
        t0 = time.perf_counter()
        out = None
        for f in frames:
            out = svc.upscale_dispatch(f)
        svc._fetch(*out)
        sustained = (time.perf_counter() - t0) / len(frames) * 1e3
        svc = _egvsr_service(dev, 3, weights, thr)
        per = []
        for f in frames:
            t1 = time.perf_counter()
            svc.upscale(f)
            per.append((time.perf_counter() - t1) * 1e3)
        rows.append(_row({"model": "egvsr-cuts", "lr": f"{h}x{w}", "cut_every": cut_every, "cut_skip": thr is not None,
                          "ms_per_frame": round(sustained, 1), "fps": round(1000 / sustained, 2),
                          "ms_p99_barrier": round(float(np.percentile(per, 99)), 1)}, dev, card))
    g = torch.Generator().manual_seed(3)
    hr = torch.rand((1, 4 * h, 4 * w, 3), generator=g).to(dev, _dtype(dev))
    rough = ((torch.rand((1, 4 * h, 4 * w, 2), generator=torch.Generator().manual_seed(4)) - 0.5) * 180.0).to(dev)
    smooth = torch.full((1, 4 * h, 4 * w, 2), 3.0, device=dev)
    for name, flow in (("fast", smooth), ("full", rough)):
        with torch.inference_mode():
            backward_warp_fast(hr, flow)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                backward_warp_fast(hr, flow)
            _sync(dev)
        ms = (time.perf_counter() - t0) / iters * 1e3
        rows.append(_row({"model": f"egvsr-warp-{name}", "lr": f"{h}x{w}", "window": "single",
                          "flow": "smooth" if name == "fast" else "rough", "ms_per_frame": round(ms, 1)}, dev, card))
    return rows


def bench_denoise(iters: int, batch: int, dev: torch.device, card: str | None) -> list[dict]:
    """The production denoise path (chunked BSVD-32 + SRVGG + post),
    LR level 3 -> 1440p, timed once the stream is warm."""
    from ..models import bsvd

    lr = levels.LR_LEVELS[3]
    out = levels.HR_LEVELS[0]
    svc = service_mod.EsrganUpscalerService(lr_level=3, output_shape=out, denoising=True, denoise_rate=1.0,
                                            batch_size=batch, compute_dtype=_dtype(dev), device=dev)
    svc.proc_init()
    frames = np.zeros((batch, *lr, 3), np.uint8)
    for _ in range(-(-bsvd.SHIFT_NUM // batch) + 1):
        svc.upscale(frames)  # cold, then the first warm chunk
    dt = _time_dispatches(svc, frames, iters)
    return [_row({"model": "realesrgan+bsvd", "lr": f"{lr[0]}x{lr[1]}", "out": f"{out[0]}x{out[1]}",
                  "fps": round(iters * batch / dt, 2)}, dev, card)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_matrix", description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="+", default=["3,0", "5,0", "1,0"], help="lr_level,hr_level pairs")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--suites", nargs="+", default=["sr"], choices=["sr", "egvsr", "denoise", "cuts"],
                   help="which benchmark families to run")
    p.add_argument("--egvsr-weights", default=None,
                   help=".pth for the cuts suite (e.g. weights/minted/egvsr-derived-x4.pth): a trained "
                        "FNet emits real rough flow at cuts")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def run(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev.type)
    extra = []
    if "egvsr" in args.suites:
        extra += bench_egvsr(args.iters, dev, card)
    if "cuts" in args.suites:
        extra += bench_cuts(args.iters, dev, card, weights=args.egvsr_weights)
    if "denoise" in args.suites:
        extra += bench_denoise(args.iters, args.batch, dev, card)
    results = bench_sr(args.configs, args.batch, args.iters, dev, card) if "sr" in args.suites else []
    rows = results + extra
    print(json.dumps({"matrix": rows}), flush=True)
    return rows


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
