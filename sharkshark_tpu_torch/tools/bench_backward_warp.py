"""K3, EGVSR's backward warp kernel (csrc/backward_warp.cu), alone on one
GPU at the EGVSR path's shape: x (1, 2880, 5120, 3) bf16, a bf16 flow.

    python -m sharkshark_tpu_torch.tools.bench_backward_warp [--reps 30] [--out FILE]

Flows: a smooth one within +-96 px, bilinear from a grid 32 px apart, so
that it turns by ~2 px a pixel; a rough uniform +-95 px one; and two with
the gradients of real motion, a constant pan (12.25, 4.5) px (about the
motion of chip_smoke.py's panning scene at the HR frame) and a gentle +-24 px
one from a grid 256 px apart; and the smooth one with the skip flag set.
Each in the NHWC and the s2d_out=4 layouts.  For each case: the kernel
against backward_warp_plain (max |err| <= TOL, and the skip bit-exact),
then
  - kernel_ms: the median of `--reps` CUDA-event timings of one call
    (the wrapper's host work included), as chip_smoke.py times every
    kernel;
  - device_ms: the same for 20 calls back to back, divided by 20:
    the device time, with the host's work overlapped (bench_tsm_conv's
    `device_ms`);
  - plain_ms, and library_ms / library_device_ms: F.grid_sample on the
    same x and flow as its normalised grid (one PyTorch call of the same
    function, a yardstick the port never calls), timed both ways;
beside the bound (`work`, and `bound` from tools/bench_tsm_conv.py).
Prints one JSON object, with the card's name and power limit.
chip_smoke.py runs the same measurement (`measure`).

To time two versions of the kernel in one call, run this file as a
script with PYTHONPATH at the other checkout
(`PYTHONPATH=OTHER python sharkshark_tpu_torch/tools/bench_backward_warp.py`):
it then imports that checkout's `sharkshark_tpu_torch` (it needs only
`ops/warp.py`'s `backward_warp_fast`, `backward_warp_plain` and
`launches`, `ops`' `resize` and `space_to_depth`, and
`tools/bench_tsm_conv.py`'s `time_ms`, `device_ms`, `bound` and
`PEAK_F32_FLOPS`), and
`package` in its output names which one ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

import sharkshark_tpu_torch
from sharkshark_tpu_torch.ops import resize, space_to_depth
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.tools.bench_tsm_conv import PEAK_F32_FLOPS, bound, device_ms, time_ms

SHAPE = (1, 2880, 5120, 3)  # EGVSR's HR frame at 720p -> 1440p (lr-level 3)
# The kernel samples at u + dx, the plain version through the normalised
# grid, up to ~1e-3 px apart at W = 5120, so a value near a bf16 rounding
# step may round one ulp (2^-8 below 1.0) the other way: atol of two ulps
TOL = 2.0**-7
FLOPS_PER_VALUE = 15  # the clamps, floors, weights and three lerps, in float32


def smooth_flow(g, n: int, h: int, w: int, max_disp: float, dev, step: int = 32) -> torch.Tensor:
    """Flow as tests/test_warp_band.py makes it: uniform [-1, 1) on a
    coarse grid `step` px apart, bilinearly upsampled, times max_disp."""
    coarse = torch.rand((n, max(h // step, 2), max(w // step, 2), 2), generator=g, device=dev) * 2 - 1
    return resize(coarse, (h, w), "bilinear") * max_disp


def work(shape: tuple[int, int, int, int] = SHAPE, x_bytes: int = 2, flow_bytes: int = 2,
         skipped: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one warp of x (n, h, w, c): x read and out
    written once, the flow read once unless the skip makes it unneeded,
    and the one-byte skip flag; FLOPS_PER_VALUE float32 operations per
    output value outside the tensor cores, none for the skip's copy."""
    n, h, w, c = shape
    values = n * h * w * c
    nbytes = 2 * values * x_bytes + (0 if skipped else n * h * w * 2 * flow_bytes) + 1
    return (0 if skipped else FLOPS_PER_VALUE * values), nbytes


def measure(shape: tuple[int, int, int, int] = SHAPE, reps: int = 30) -> list[dict]:
    """K3 at one bf16 shape with a bf16 flow, in the ten cases: each
    checked against its plain version (raises outside TOL, or if the skip
    is not exact), then timed beside the plain version, F.grid_sample
    and the bound."""
    dev = torch.device("cuda")
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(shape, generator=g, device=dev).to(torch.bfloat16)
    flows = {
        "smooth96": smooth_flow(g, n, h, w, 96.0, dev).to(torch.bfloat16),
        "rough95": ((torch.rand((n, h, w, 2), generator=g, device=dev) * 2 - 1) * 95).to(torch.bfloat16),
        "pan": torch.tensor([12.25, 4.5], device=dev).expand(n, h, w, 2).to(torch.bfloat16).contiguous(),
        "gentle24": smooth_flow(g, n, h, w, 24.0, dev, step=256).to(torch.bfloat16),
    }
    no, yes = torch.zeros(1, dtype=torch.bool, device=dev), torch.ones(1, dtype=torch.bool, device=dev)
    iu = torch.linspace(-1.0, 1.0, w, device=dev)[None, None, :]
    iv = torch.linspace(-1.0, 1.0, h, device=dev)[None, :, None]
    x_nchw = x.permute(0, 3, 1, 2)
    rows = []
    for flow_name, skip in (("smooth96", no), ("rough95", no), ("pan", no), ("gentle24", no), ("smooth96", yes)):
        flow = flows[flow_name]
        grid = torch.stack([iu + flow[..., 0].float() / ((w - 1) / 2),
                            iv + flow[..., 1].float() / ((h - 1) / 2)], dim=-1).to(x.dtype)
        skipped = bool(skip)
        for s2d in (0, 4):
            name = f"{flow_name}{'+skip' if skipped else ''} {'s2d4' if s2d else 'nhwc'}"
            before = wp.launches
            got = wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip)
            torch.cuda.synchronize()
            assert wp.launches == before + 1, "the wrapper did not launch the kernel"
            want = wp.backward_warp_plain(x, flow, s2d_out=s2d, skip=skip)
            assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
            err = (got.float() - want.float()).abs()
            max_err = err.max().item()
            assert max_err <= TOL, f"backward_warp {name}: max |err| {max_err} > {TOL}"
            if skipped:
                ref = space_to_depth(x, s2d) if s2d else x
                assert torch.equal(got, ref), f"backward_warp {name}: the skip did not copy x exactly"
            mismatch = (err > 0).float().mean().item()
            del got, want, err

            def kernel():
                return wp.backward_warp_fast(x, flow, s2d_out=s2d, skip=skip)

            def library():
                return F.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

            flops, nbytes = work(shape, x.element_size(), flow.element_size(), skipped)
            row = {"case": name, "shape": list(shape), "max_abs_err": max_err, "mismatch_share": mismatch,
                   "kernel_ms": time_ms(kernel, reps), "device_ms": device_ms(kernel, reps),
                   "plain_ms": time_ms(lambda: wp.backward_warp_plain(x, flow, s2d_out=s2d, skip=skip), 10),
                   "library_ms": time_ms(library, reps), "library_device_ms": device_ms(library, reps),
                   "flops": flops, "bytes": nbytes, "peak_flops": PEAK_F32_FLOPS,
                   **bound(flops, nbytes, PEAK_F32_FLOPS)}
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_backward_warp: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    res = {"card": card, "package": str(Path(sharkshark_tpu_torch.__file__).parent),
           "cases": measure(reps=args.reps)}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
