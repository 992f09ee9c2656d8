"""Where the time of the port's EGVSR step goes, on one GPU.

    python -m sharkshark_tpu_torch.tools.profile_egvsr_step [--iters 8] [--out FILE]

Runs steps.egvsr_upscale_step at the CLI's default shapes (720p in, HR
frame 2880x5120, 1440p out, bf16, cut_threshold 0.12, the repo's minted
EGVSR weights) on smooth panning frames: a few steps to warm up, then `--iters`
steps, and prints one JSON object with
  - step_ms: device-synchronised host time per step (one frame),
  - busy_ms: the sum of the device time of the kernels of one step,
  - idle_share: 1 - busy_ms / step_ms,
  - stages: device ms per step under each stage (torch.profiler ranges
    around FNet, the flow upsample, the cut test, the K3 warp, SRNet, and
    the HR post-processing: clamp, output resize, uint8),
  - conv_in_ms / conv_body_ms: CUDA-event times of SRNet's first conv
    (51 -> 64 channels) and of one body conv (64 -> 64) at 720x1280,
  - top_kernels: the kernels with the most device time per step,
and, with --out, writes the same object to FILE.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models import egvsr, torch_import
from ..ops import conv2d
from ..ops import warp as wp
from ..upscale import steps
from .profile_denoise_step import _annotate

ROOT = Path(__file__).resolve().parents[2]
MINTED = ROOT / "weights" / "minted"


def _event_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_egvsr_step: needs a CUDA device")
    dev, dtype = torch.device("cuda"), torch.bfloat16
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    ranges = [
        (egvsr, "fnet_apply", "egvsr.fnet"),
        (egvsr, "_upsample_flow", "egvsr.upsample_flow"),
        (egvsr, "_cut_flags", "egvsr.cut_test"),
        (egvsr, "backward_warp_fast", "egvsr.warp_k3"),
        (egvsr, "srnet_apply", "egvsr.srnet"),
        (steps, "_resize_to_output", "post.resize_to_output"),
        (steps, "_emit", "post.emit_uint8"),
    ]
    labels = {label for _, _, label in ranges}
    for module, name, label in ranges:
        _annotate(module, name, label)

    sd = torch_import.load_state_dict(str(MINTED / "egvsr-derived-x4.pth"))
    cfg = egvsr.config_from_torch(sd)
    params = torch_import.to_tensors(egvsr.from_torch(sd, cfg), dev, dtype)
    spec = steps.UpscaleSpec(lr_shape=(720, 1280), output_shape=(1440, 2560), compute_dtype=dtype)
    # a smooth random scene panning 3 px right and 1 px down per frame, so
    # that no frame is a scene cut and every step warps
    rng = np.random.default_rng(0)
    coarse = torch.from_numpy(rng.random((3, 720 // 16 + 8, 1280 // 16 + 8), dtype=np.float32))
    scene = torch.nn.functional.interpolate(coarse[None], scale_factor=16, mode="bicubic")[0]
    scene = (scene.permute(1, 2, 0) * 200 + 28).clamp(0, 255).to(torch.uint8)
    frames = [scene[i : i + 720, 3 * i : 3 * i + 1280][None].contiguous().to(dev) for i in range(16)]
    state = egvsr.init_recurrent_state(1, 720, 1280, cfg, dtype, dev)
    k = 0

    def step():
        nonlocal state, k
        out, state = steps.egvsr_upscale_step(params, state, frames[k % len(frames)], spec,
                                              cut_threshold=0.12, cfg=cfg)
        k += 1
        return out

    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / args.iters * 1e3

        wp.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()
        launches = wp.launches

        g = torch.Generator(device=dev).manual_seed(1)
        x_in = torch.rand((1, 720, 1280, 51), generator=g, device=dev).to(dtype)
        x_body = torch.rand((1, 720, 1280, 64), generator=g, device=dev).to(dtype)
        p_in, p_body = params["srnet"]["conv_in"], params["srnet"]["blocks"][0][0]
        conv_in_ms = _event_ms(lambda: conv2d(x_in, p_in["w"], p_in["b"], padding=1))
        conv_body_ms = _event_ms(lambda: conv2d(x_body, p_body["w"], p_body["b"], padding=1))

    events = prof.key_averages()
    per_step = 1e-3 / args.iters  # profiler us over iters -> ms per step
    stages = {e.key: e.device_time_total * per_step for e in events if e.key in labels}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in labels]
    busy_ms = sum(e.device_time_total for e in kernels) * per_step
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * per_step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    res = {
        "card": card, "shape": "720x1280 -> HR 2880x5120 -> 1440x2560", "cfg": cfg._asdict(),
        "iters": args.iters, "step_ms": step_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / step_ms, "warp_launches_per_step": launches / args.iters,
        "kernel_launches_per_step": len(kernels) / args.iters, "stages": stages,
        "conv_in_ms": conv_in_ms, "conv_body_ms": conv_body_ms,
        "top_kernels": [{"name": k[:120], "ms": v} for k, v in top],
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
