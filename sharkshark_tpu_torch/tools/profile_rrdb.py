"""Where the time of RRDBNet x4plus's apply goes, on one GPU.

    python -m sharkshark_tpu_torch.tools.profile_rrdb [--batch 4] [--iters 3] [--out FILE]

Runs models/rrdbnet.apply at its published config (23 blocks, 64
features, growth 32) on a (batch, 720, 1280, 3) bf16 input with seeded
weights, and prints one JSON object with
  - ms_per_frame: device time of one apply (CUDA events, median of
    --iters) over the batch,
  - bound_ms, bound_share: the least time by operations at the H100's
    dense bf16 peak, and its share of ms_per_frame,
  - peak_mem_gb: torch.cuda.max_memory_allocated over the calls,
  - busy_ms, idle_share: the kernels' device time per apply (profiled)
    against the apply's synchronised host time,
  - groups: device ms per frame by kind of kernel (cuDNN convs, the dense
    blocks' torch.cat copies, elementwise adds and scales, leaky ReLU,
    other), with the concatenations' bytes and their bound by bytes,
  - top_kernels: the kernels with the most device time per frame,
and, with --out, writes the same object to FILE.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..models import rrdbnet, torch_import
from .bench_tsm_conv import PEAK_BF16_FLOPS, PEAK_BYTES

_GROUPS = (  # kernel-name fragments, first match wins
    ("concat", ("catarray",)),
    ("conv", ("conv", "xmma", "cudnn", "cutlass", "gemm")),
    ("leaky_relu", ("leaky",)),
    ("add_and_scale", ("add", "mul", "aunaryfunctor")),
)


def flops_per_frame(cfg: rrdbnet.RRDBConfig, h: int, w: int) -> int:
    """Operations (2 per MAC) of one h x w frame: conv_first, the dense
    blocks and conv_body at LR, conv_up1 at 2x, conv_up2, conv_hr and
    conv_last at 4x."""
    nf, gc = cfg.num_feat, cfg.num_grow_ch
    rdb = sum((nf + k * gc) * (gc if k < 4 else nf) for k in range(5))
    lr = cfg.num_in_ch * nf + cfg.num_block * 3 * rdb + nf * nf
    hr = 4 * nf * nf + 16 * 2 * nf * nf + 16 * nf * cfg.num_out_ch
    return 2 * 9 * (lr + hr) * h * w


def concat_bytes_per_frame(cfg: rrdbnet.RRDBConfig, h: int, w: int, itemsize: int = 2) -> int:
    """Bytes the dense blocks' torch.cat calls move on one frame: each
    concatenation of nf + k*gc channels (k = 1..4) reads its parts and
    writes the whole once."""
    channels = sum(cfg.num_feat + k * cfg.num_grow_ch for k in range(1, 5))
    return 2 * channels * itemsize * h * w * 3 * cfg.num_block


def _group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in _GROUPS if any(k in low for k in keys)), "other")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rrdb: needs a CUDA device")
    dev, n, h, w = torch.device("cuda"), args.batch, 720, 1280
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = rrdbnet.X4PLUS
    params = torch_import.to_tensors(
        rrdbnet.init_params(torch.Generator().manual_seed(41), cfg), dev, torch.bfloat16)
    x = torch.rand((n, h, w, 3), generator=torch.Generator().manual_seed(0)).to(dev, torch.bfloat16)

    with torch.inference_mode():
        rrdbnet.apply(params, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            rrdbnet.apply(params, x)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rrdbnet.apply(params, x)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    per_frame = 1e-3 / n  # profiler us per apply -> ms per frame
    busy = sum(e.device_time_total for e in kernels) * 1e-3
    groups: dict[str, dict] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        g = groups.setdefault(_group(e.name), {"ms": 0.0, "launches": 0})
        g["ms"] += e.device_time_total * per_frame
        g["launches"] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * per_frame
    cat_bytes = concat_bytes_per_frame(cfg, h, w)
    if "concat" in groups:
        groups["concat"].update(bytes=cat_bytes, bound_ms=cat_bytes / PEAK_BYTES * 1e3)
    ms = statistics.median(times) / n
    bound_ms = flops_per_frame(cfg, h, w) / PEAK_BF16_FLOPS * 1e3
    res = {
        "card": card, "shape": f"({n},{h},{w},3) -> ({n},{4 * h},{4 * w},3) bf16", "config": cfg._asdict(),
        "ms_per_frame": ms, "passes_ms_per_frame": [t / n for t in times],
        "tflop_per_frame": flops_per_frame(cfg, h, w) / 1e12, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
        "peak_mem_gb": peak / 1e9, "busy_ms": busy, "host_ms": host_ms, "idle_share": 1.0 - busy / host_ms,
        "kernel_launches": len(kernels), "groups": groups,
        "top_kernels": [{"name": k[:120], "ms": v} for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]],
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
