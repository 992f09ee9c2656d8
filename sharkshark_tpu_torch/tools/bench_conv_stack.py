"""K4, the conv + bias + PReLU kernel (csrc/conv_stack.cu), alone on one
GPU at SRVGG's body shape: (4, 720, 1280, 64) bf16, with bias, at L = 1
(or each depth `--layers` names; L layers are L launches).

    python -m sharkshark_tpu_torch.tools.bench_conv_stack [--layers 1 2 4] [--reps 30] [--out FILE]

The kernel against fused_conv_stack_plain (within 0.02 x max(|ref|max,
1), as the Pallas kernel's test), then the median of `--reps` CUDA-event
timings of the kernel, of the plain version and of the layer-by-layer
route (cuDNN conv with bias, then PReLU: a yardstick here, which the body
runs only with conv_stack=0), one call per event pair (`kernel_ms`,
`plain_ms`, `library_ms`) and, for the kernel and the layer-by-layer
route, calls back to back (`device_ms`, `library_device_ms`), beside the
bound and the kernel's share of it over `device_ms`.  Timing and bound
come from tools/bench_tsm_conv.py.  Prints one JSON object (a row per depth), with
the card's name and power limit.  chip_smoke.py runs the same
measurement (`measure`) at L = 1, 2 and 4.

To time two versions of the kernel in one call, run this file as a
script with PYTHONPATH at the other checkout
(`PYTHONPATH=OTHER python sharkshark_tpu_torch/tools/bench_conv_stack.py`):
it then imports that checkout's `sharkshark_tpu_torch` (it needs only
`ops/conv_stack.py`'s `fused_conv_stack`, `fused_conv_stack_plain` and
`launches`, `ops`' `conv2d` and `prelu`, and `tools/bench_tsm_conv.py`'s
`time_ms`, `device_ms` and `bound`), and `package` in its output names
which one ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

import sharkshark_tpu_torch
from sharkshark_tpu_torch.ops import conv2d, prelu
from sharkshark_tpu_torch.ops import conv_stack as cs
from sharkshark_tpu_torch.tools.bench_tsm_conv import bound, device_ms, time_ms

SHAPE = (4, 720, 1280)  # SRVGG's body at 720p, micro-batch 4
TOL = 0.02              # x max(|ref|max, 1), as experiments/tests/test_pallas_conv.py


def work(shape: tuple[int, int, int] = SHAPE, n_layers: int = 1, with_bias: bool = True) -> tuple[int, int]:
    """(operations, bytes) of L layers at (n, h, w, 64) bf16: 2 x 9 x 64 x
    64 per pixel and layer; x and out once each, the bf16 weights and the
    f32 alphas and biases."""
    n, h, w = shape
    c = cs.CHANNELS
    flops = n_layers * 2 * 9 * c * c * n * h * w
    nbytes = 2 * (n * h * w * c * 2) + n_layers * (9 * c * c * 2 + c * 4 * (2 if with_bias else 1))
    return flops, nbytes


def measure(n_layers: int = 1, with_bias: bool = True, shape: tuple[int, int, int] = SHAPE,
            reps: int = 30) -> dict:
    """K4 at one shape and depth: checked against its plain version
    (raises outside the tolerance), then timed beside the plain version,
    the layer-by-layer route and the bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3000 + n_layers)
    n, h, w = shape
    x = torch.randn((n, h, w, 64), generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn((n_layers, 3, 3, 64, 64), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    a = torch.linspace(0.1, 0.4, n_layers * 64, device=dev).reshape(n_layers, 64)
    b = torch.randn((n_layers, 64), generator=g, device=dev) * 0.1 if with_bias else None

    before = cs.launches
    got = cs.fused_conv_stack(x, wt, a, b)
    torch.cuda.synchronize()
    launches = cs.launches - before
    assert launches > 0, "the wrapper did not launch the kernel"
    want = cs.fused_conv_stack_plain(x, wt, a, b)
    assert got.shape == want.shape == x.shape and got.dtype == torch.bfloat16
    max_err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    name = f"fused_conv_stack L={n_layers} {'bias' if with_bias else 'no bias'}"
    assert max_err <= TOL * max(scale, 1.0), f"{name}: max |err| {max_err} > {TOL} x max({scale}, 1)"
    assert torch.isfinite(got.float()).all()
    del want

    def layer_by_layer():
        y = x
        for l in range(n_layers):
            y = prelu(conv2d(y, wt[l], None if b is None else b[l].to(x.dtype), padding=1), a[l])
        return y

    def kernel():
        return cs.fused_conv_stack(x, wt, a, b)

    flops, nbytes = work(shape, n_layers, with_bias)
    row = {"layers": n_layers, "bias": with_bias, "shape": [n, h, w, 64], "launches_per_call": launches,
           "max_abs_err": max_err, "ref_max": scale,
           "kernel_ms": time_ms(kernel, reps), "device_ms": device_ms(kernel, reps),
           "plain_ms": time_ms(lambda: cs.fused_conv_stack_plain(x, wt, a, b), max(reps // 6, 3)),
           "library_ms": time_ms(layer_by_layer, reps), "library_device_ms": device_ms(layer_by_layer, reps),
           "flops": flops, "bytes": nbytes, **bound(flops, nbytes)}
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[1], help="depths L to time")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_conv_stack: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    res = {"card": card, "package": str(Path(sharkshark_tpu_torch.__file__).parent),
           "rows": [measure(L, reps=args.reps) for L in args.layers]}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
