"""The sharded EGVSR serving step (parallel/sharded.py::make_sharded_egvsr_step)
on the card at full width: EgvsrUpscalerService with the minted FRNet on a
1x4 mesh, 720p -> 1440p (HR frame 2880x5120), bf16, one frame a step, through
the bands' CUDA graphs and through their eager reference.

    python -m sharkshark_tpu_torch.tools.bench_sharded_egvsr [--steps 24] [--rounds 2] [--out FILE]

The mesh's devices are the cards in turn where two or more are visible,
else cuda:0 four times (the bands then run one after another).  Each pass
makes a fresh service, runs two warm-up steps (a band's phase is captured
at its second call), then `--steps` steps over panning frames, and reads:
  - ms_per_frame: the steps back to back, between two synchronisations of
    every card, over the steps;
  - host_ms: the median host time of one step call;
  - k3_launches_per_step: K3's launches (its wrapper's count, which a
    graph's replay adds to) over the timed steps, a step.
Passes run eager, graphs, graphs, eager, `--rounds` times.  Prints one
JSON object with the card's name and power limit.

To time two checkouts in one call, run this file as a script with
PYTHONPATH at the other checkout (`PYTHONPATH=OTHER python
sharkshark_tpu_torch/tools/bench_sharded_egvsr.py`): it then imports that
checkout's `sharkshark_tpu_torch` and its minted weights (it needs only
`EgvsrUpscalerService(mesh=)`, `parallel.make_mesh`,
`parallel.sharded._eager_reference` and `ops.warp.launches`), and
`package` in its output names which one ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import sharkshark_tpu_torch
from sharkshark_tpu_torch.ops import warp as wp
from sharkshark_tpu_torch.parallel import make_mesh, sharded
from sharkshark_tpu_torch.upscale import service as service_mod

WEIGHTS = Path(sharkshark_tpu_torch.__file__).resolve().parent.parent / "weights" / "minted" / "egvsr-derived-x4.pth"


def panning_frames(n: int, h: int = 720, w: int = 1280, seed: int = 13, pan: int = 3) -> np.ndarray:
    """n uint8 frames of a smooth random scene panning `pan` px right and
    1 px down a frame, with fresh noise on each (as chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((h // 16 + 8, w // 16 + 8, 3), dtype=np.float32))
    scene = torch.nn.functional.interpolate(coarse.permute(2, 0, 1)[None], scale_factor=16, mode="bicubic",
                                            align_corners=False)[0].permute(1, 2, 0).numpy()
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        view = scene[i : i + h, pan * i : pan * i + w]
        out[i] = np.clip(view * 200 + 28 + rng.normal(0, 6, view.shape), 0, 255).astype(np.uint8)
    return out


def mesh_devices(n: int = 4) -> list[torch.device]:
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count if count >= 2 else 0) for i in range(n)]


def _sync() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def run_pass(eager: bool, frames: np.ndarray) -> dict:
    """One fresh service over the frames (two warm-up steps, then the
    timed ones), through the eager reference or the bands' graphs."""
    mesh = make_mesh(devices=mesh_devices(), spatial=4)
    with sharded._eager_reference() if eager else contextlib.nullcontext():
        svc = service_mod.EgvsrUpscalerService(lr_level=3, output_shape=(1440, 2560), weights=str(WEIGHTS),
                                               mesh=mesh)
        svc.proc_init()
    xs = [torch.from_numpy(frames[i : i + 1]) for i in range(len(frames))]

    def step(x):
        _, svc._state = svc._step(svc._params, svc._state, x)

    with torch.inference_mode():
        for x in xs[:2]:
            step(x)
        _sync()
        before, host = wp.launches, []
        t0 = time.perf_counter()
        for x in xs[2:]:
            t = time.perf_counter()
            step(x)
            host.append(time.perf_counter() - t)
        _sync()
        total = time.perf_counter() - t0
    steps = len(xs) - 2
    svc.close()
    return {"route": "eager" if eager else "graphs", "steps": steps, "ms_per_frame": total / steps * 1e3,
            "host_ms": statistics.median(host) * 1e3, "k3_launches_per_step": (wp.launches - before) / steps}


def measure(steps: int = 24, rounds: int = 2) -> list[dict]:
    frames = panning_frames(steps + 2)
    return [run_pass(eager, frames) for _ in range(rounds) for eager in (True, False, False, True)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_sharded_egvsr: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    passes = measure(args.steps, args.rounds)
    res = {"card": card, "cards": torch.cuda.device_count(), "mesh": [str(d) for d in mesh_devices()],
           "package": str(Path(sharkshark_tpu_torch.__file__).parent), "passes": passes,
           **{f"{r}_ms_per_frame": statistics.mean(p["ms_per_frame"] for p in passes if p["route"] == r)
              for r in ("eager", "graphs")}}
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)


if __name__ == "__main__":
    main()
