"""The control of the output check: the plain reference put in the
program's place, computed a precision below the configuration's bf16
(float8 e4m3 on every conv's input and weight, reference/quant.py), and
read by the same comparison as a run.  It has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --frames <n> [--json-out PATH]

For each seed it regenerates the source, takes a timeline of n frames
with nothing dropped (what an unloaded run's service sees), draws the
sample as a run's sink does (reservoir over the outputs),
and reads `psnr_min_db` of the float8 reference against the float32 one.
Runs on the card (CUDA) or, with --device cpu, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .accounting import build_outputs, micro_batches
from .check import psnr_db
from .content import Scene
from .reference.quant import fp8_e4m3
from .reference.stream import Reference
from .registry import ROOT, load_benchmark, load_cell

__all__ = ["control_reading"]


def _sample(n_outputs: int, keep: int, seed: int) -> list[int]:
    """The sink's reservoir sample of `keep` out of n_outputs."""
    rng = np.random.default_rng(seed)
    slots = list(range(min(keep, n_outputs)))
    for i in range(keep, n_outputs):
        j = int(rng.integers(0, i + 1))
        if j < keep:
            slots[j] = i
    return sorted(slots)


def control_reading(cell, seed: int, frames: int, device) -> dict:
    """psnr of the control against the reference over one seed's sample."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    batch = min(4, int(traffic["capture_fps"]))
    fps = int(traffic["capture_fps"])
    captures = [(min(fps, frames - s), 0.0) for s in range(0, frames, fps)]
    service = [(k, len(r)) for k, r in enumerate(micro_batches(captures, batch))]
    outputs, tl = build_outputs(cfg["model"], captures, service, batch)
    picked = [outputs[k] for k in _sample(len(outputs), traffic["check_frames"], seed ^ 0x5EED)
              if outputs[k].carries is not None]
    scene = Scene(seed, *cfg["lr_shape"], pan=tuple(traffic["pan"]), sigma=traffic["noise_sigma"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.monotonic()
    ref = Reference(cfg, ROOT, device).outputs(scene, tl.frames, picked)
    t_ref = time.monotonic() - t
    ctl = Reference(cfg, ROOT, device, quant=fp8_e4m3).outputs(scene, tl.frames, picked)
    psnr = [psnr_db(c, r) for c, r in zip(ctl, ref)]
    return {"seed": seed, "positions": [o.position for o in picked], "psnr": psnr, "psnr_min_db": min(psnr),
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, required=True, help="source frames of the timeline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload, load_benchmark(ROOT))
    rows = []
    for s in args.seeds.split(","):
        row = control_reading(cell, int(s), args.frames, torch.device(args.device))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "frames": args.frames,
               "control_psnr_min_db_max": max(r["psnr_min_db"] for r in rows),
               "limit": cell.config["limits"]["psnr_min_db"]}
    summary["control_fails"] = summary["control_psnr_min_db_max"] < summary["limit"]
    print(json.dumps(summary), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
