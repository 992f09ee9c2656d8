"""K1, the temporal-shift conv kernel (csrc/tsm_conv.cu), alone on one
GPU at the warm denoise chunk's two shapes: T=4, N=1, C=64 at 360x640
and C=128 at 180x320, bf16, relu6.

    python -m sharkshark_tpu_torch.tools.bench_tsm_conv [--reps 30] [--out FILE]

For each shape: the kernel against tsm_conv_plain (rtol = atol = 0.05),
then the median of `--reps` CUDA-event timings of the kernel, of the
plain version and of one cuDNN conv over the pre-built mixed input (a
yardstick the port never calls), beside the bound: the larger of the
bytes (each input read once, the output written once) over 3.35 TB/s
and the operations over 989 TFLOP/s (H100 SXM data sheet).  Also the
Prints one JSON object, with the card's name and power limit.
chip_smoke.py runs the same measurement (`measure`) and takes its
timing and bound helpers from here.

To time two versions of the kernel in one call, run this file as a
script with PYTHONPATH at the other checkout
(`PYTHONPATH=OTHER python sharkshark_tpu_torch/tools/bench_tsm_conv.py`):
it then imports that checkout's `sharkshark_tpu_torch` (it needs only
`ops/tsm_conv.py`'s `tsm_conv`, `tsm_conv_plain` and `launches`), and
`package` in its output names which one ran.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

import sharkshark_tpu_torch
from sharkshark_tpu_torch.ops import tsm_conv as tsm

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores, NVIDIA data sheet
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
TOL = 0.05                # rtol = atol, as tests/test_tsm_conv.py
SHAPES = ((64, 360, 640), (128, 180, 320))


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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def built_mix(x: torch.Tensor, prev1: torch.Tensor, left0: torch.Tensor) -> torch.Tensor:
    """The temporal-shift conv's mixed input of a (T, 1, H, W, C) chunk as
    a channels_last NCHW tensor, for one cuDNN conv over it."""
    t, _, h, w, c = x.shape
    fold = c // 8
    hist = torch.cat([left0[None], prev1[None, ..., fold : 2 * fold], x[: t - 2, ..., fold : 2 * fold]])
    rest = torch.cat([prev1[None, ..., 2 * fold :], x[: t - 1, ..., 2 * fold :]])
    return torch.cat([x[..., :fold], hist[:t], rest], -1).reshape(t, h, w, c).permute(0, 3, 1, 2)


def oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def measure(c: int, h: int, w: int, t: int = 4, reps: int = 30) -> dict:
    """K1 at one (T, 1, H, W, C) shape: checked against its plain version
    (raises outside rtol = atol = TOL), then timed beside the plain
    version, one cuDNN conv on the built mix and the bound."""
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
    bad = (err > TOL + TOL * want.float().abs()).sum().item()
    max_err = err.max().item()
    assert bad == 0, f"tsm_conv C={c}: {bad} values outside rtol=atol={TOL}, max |err| {max_err}"
    assert torch.isfinite(got.float()).all()

    mix, w_oihw = built_mix(x, prev1, left0), oihw(wt)
    kernel_ms = time_ms(lambda: tsm.tsm_conv(x, prev1, left0, wt, b, "relu6"), reps)
    plain_ms = time_ms(lambda: tsm.tsm_conv_plain(x, prev1, left0, wt, b, "relu6"), reps)
    library_ms = time_ms(lambda: F.conv2d(mix, w_oihw, b, padding=1), reps)
    flops = 2 * 9 * c * c * h * w * t
    nbytes = sum(a.numel() * a.element_size() for a in (x, prev1, left0, wt, b, got))
    row = {"c": c, "h": h, "w": w, "t": t, "max_abs_err": max_err, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "flops": flops, "bytes": nbytes,
           **bound(flops, nbytes)}
    row["bound_share"] = row["bound_ms"] / kernel_ms
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_tsm_conv: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    res = {"card": card, "package": str(Path(sharkshark_tpu_torch.__file__).parent),
           "shapes": [measure(c, h, w, reps=args.reps) for c, h, w in SHAPES]}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
