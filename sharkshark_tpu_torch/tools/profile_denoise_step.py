"""Where the time of the port's warm denoise step goes, on one GPU.

    python -m sharkshark_tpu_torch.tools.profile_denoise_step [--iters 5] [--out FILE]
        [--tsm-pair] [--conv-stack L]

Runs steps.upscale_batch_denoise at the main path's shapes (720p ->
1440p, T=4, bf16, the repo's minted SRVGG and BSVD-32 weights) on the
service's routes (K1 per shift conv, the SRVGG body through K4 one
layer a launch, the skip rings updated in place; --tsm-pair selects K2,
--conv-stack L K4's depth, 0 the layer-by-layer body): four cold chunks to
reach the warm regime, then `--iters` warm steps, and prints one JSON
object with
  - step_ms: device-synchronised host time per warm step,
  - busy_ms: the sum of the device time of the kernels of one step,
  - idle_share: 1 - busy_ms / step_ms,
  - stages: device ms per step under each stage (torch.profiler ranges
    around bsvd.chunk_step, the temporal-shift convs (K1, K2), the SRVGG
    body, K4, the fused epilogue, sharpen and color match),
  - launches_per_step: each kernel's launches per warm step,
  - top_kernels: the kernels with the most device time per step,
and, with --out, writes the same object to FILE.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..models import bsvd, srvgg, torch_import
from ..ops import conv_stack as cs
from ..ops import fused_epilogue
from ..ops import tsm_conv as tsm
from ..upscale import steps

ROOT = Path(__file__).resolve().parents[2]
MINTED = ROOT / "weights" / "minted"


def _annotate(module, name: str, label: str) -> None:
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    setattr(module, name, wrapped)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    ap.add_argument("--tsm-pair", action="store_true", help="BSVD's warm mem blocks through K2")
    ap.add_argument("--conv-stack", type=int, default=srvgg.DEFAULT_CONV_STACK,
                    help="SRVGG body layers per K4 launch (0: layer by layer; default: the service's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_denoise_step: needs a CUDA device")
    dev, dtype, t = torch.device("cuda"), torch.bfloat16, args.batch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    ranges = [
        (steps.bsvd, "chunk_step", "bsvd.chunk_step"),
        (bsvd.tsm, "tsm_conv", "bsvd.tsm_conv"),
        (bsvd.tsm, "tsm_conv_pair", "bsvd.tsm_conv_pair"),
        (srvgg, "_body", "srvgg.body"),
        (srvgg.cs, "fused_conv_stack", "srvgg.fused_conv_stack"),
        (fused_epilogue, "ps4_bicubic_down_rational", "srvgg.fused_epilogue"),
        (fused_epilogue, "nearest4_bicubic_down_rational", "srvgg.fused_epilogue_residual"),
        (steps, "sharpen", "post.sharpen"),
        (steps, "global_color_match", "post.global_color_match"),
    ]
    labels = {label for _, _, label in ranges}
    for module, name, label in ranges:
        _annotate(module, name, label)

    spec = steps.UpscaleSpec(lr_shape=(720, 1280), output_shape=(1440, 2560),
                             denoise_rate=0.75, compute_dtype=dtype)
    params = torch_import.to_tensors({
        "sr": srvgg.from_torch(torch_import.load_state_dict(str(MINTED / "srvgg-derived-x4.pth"))),
        "denoise": bsvd.from_torch(torch_import.load_state_dict(str(MINTED / "bsvd-derived-32.pth"))),
    }, dev, dtype)

    def sr_apply(p, x):
        return srvgg.apply_down_rational(p, x, 2, 1, conv_stack=args.conv_stack)

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (t, 720, 1280, 3), dtype=np.uint8)).to(dev)
    state = steps.init_denoise_state(1, spec, device=dev)

    def step():
        nonlocal state
        out, state = steps.upscale_batch_denoise(
            sr_apply, params, state, frames, spec, warm=state["t"] >= bsvd.SHIFT_NUM,
            tsm_pair=args.tsm_pair, inplace=True)
        return out

    with torch.inference_mode():
        while state["t"] < bsvd.SHIFT_NUM + t:  # cold chunks, then one warm
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / args.iters * 1e3

        tsm.launches = tsm.pair_launches = cs.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                step()
            torch.cuda.synchronize()
    launches = {"tsm_conv": tsm.launches, "tsm_conv_pair": tsm.pair_launches,
                "fused_conv_stack": cs.launches}

    events = prof.key_averages()
    per_step = 1e-3 / args.iters  # profiler us over iters -> ms per step
    stages = {e.key: e.device_time_total * per_step for e in events if e.key in labels}
    # device-side events: kernels and copies, without the ranges' own
    # device-side mirror events
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in labels]
    busy_ms = sum(e.device_time_total for e in kernels) * per_step
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * per_step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    res = {
        "card": card, "shape": "720x1280 -> 1440x2560", "batch": t, "iters": args.iters,
        "tsm_pair": args.tsm_pair, "conv_stack": args.conv_stack,
        "step_ms": step_ms, "ms_per_frame": step_ms / t, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / step_ms,
        "launches_per_step": {k: v / args.iters for k, v in launches.items()},
        "kernel_launches_per_step": len(kernels) / args.iters,
        "stages": stages, "top_kernels": [{"name": k[:120], "ms": v} for k, v in top],
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
