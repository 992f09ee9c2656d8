"""The host cost of a kernel call on one GPU: for K1 at BSVD-32's two
warm-chunk shapes and BSVD-64's C=128 shape, K4 at L = 1 on SRVGG's body
and K3 at EGVSR's HR warp, the host time a wrapper call takes (checks,
the operator's dispatch, the tensor-map encoding, the launch), the time
between two CUDA events around one call (which includes that host time
whenever the device waits for the launch), and the device time of calls
back to back (the host's work overlapped).

    python -m sharkshark_tpu_torch.tools.bench_dispatch [--calls 200] [--out FILE]

host_us: the host clock around `--calls` calls made without a
synchronise (the device's queue absorbs them), divided by the calls.
call_ms: the median of 30 event timings of one call.  device_ms: the
median of 30 event timings of 20 calls back to back, divided by 20.
Prints one JSON object with the card's name and power limit.

To time another version of the wrappers in the same call, run this file
as a script with PYTHONPATH at the other checkout
(`PYTHONPATH=OTHER python sharkshark_tpu_torch/tools/bench_dispatch.py`):
it needs only the wrappers `tsm_conv`, `fused_conv_stack` and
`backward_warp_fast`, and `package` in its output names which one ran.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

import sharkshark_tpu_torch
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.ops import tsm_conv as tsm
from sharkshark_tpu_torch.ops import warp as wp


def host_us(fn, calls: int) -> float:
    """Host microseconds a call of fn, over `calls` calls without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def event_ms(fn, batch: int, reps: int = 30) -> float:
    """Median time in ms between two CUDA events around `batch` calls of
    fn, divided by `batch`."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def cases() -> dict:
    """name -> a call of one wrapper on bf16 tensors at a path's shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    out = {}
    for c, h, w in ((64, 360, 640), (128, 180, 320), (128, 360, 640)):
        args = (randn(4, 1, h, w, c), randn(1, h, w, c), randn(1, h, w, c // 8), randn(3, 3, c, c, scale=0.05),
                randn(c, scale=0.1))
        out[f"K1 C={c} {h}x{w} T=4"] = lambda args=args: tsm.tsm_conv(*args, "relu6")
    x4, w4 = randn(4, 720, 1280, 64), randn(1, 3, 3, 64, 64, scale=0.05)
    a4, b4 = torch.full((1, 64), 0.2, device=dev), torch.randn((1, 64), generator=g, device=dev) * 0.1
    out["K4 L=1 (4,720,1280,64)"] = lambda: cs.fused_conv_stack(x4, w4, a4, b4)
    xw, fw = randn(1, 2880, 5120, 3), randn(1, 2880, 5120, 2, scale=8.0)
    out["K3 s2d_out=4 (1,2880,5120,3)"] = lambda: wp.backward_warp_fast(xw, fw, s2d_out=4)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_dispatch: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rows = {name: {"host_us": host_us(fn, args.calls), "call_ms": event_ms(fn, 1), "device_ms": event_ms(fn, 20)}
            for name, fn in cases().items()}
    res = {"card": card, "package": str(Path(sharkshark_tpu_torch.__file__).parent), "rows": rows}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
