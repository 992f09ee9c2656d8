"""Where the time of one training step goes, on one GPU.

    python -m sharkshark_tpu_torch.tools.profile_train_step --config configs/egvsr_derived.yml \\
        [--iters 8] [--out FILE]

Builds the config's recipe as the training driver does (its widths,
batch, T, crop and rates; TF32 at PyTorch's default), feeds it one seeded
random batch of the config's shapes already on the card (the step's cost
does not depend on the pixels), runs a few steps to warm up, then
`--iters` steps, and prints one JSON object with
  - step_ms: device-synchronised host time per step,
  - busy_ms: the sum of the device time of the kernels of one step,
  - idle_share: 1 - busy_ms / step_ms,
  - kernel_launches_per_step,
  - phase_ms: the forward pass with the loss, the backward pass and the
    optimizer's update, each timed apart with the device synchronised
    around it (so they sum to more than step_ms, where they overlap),
  - top_kernels: the kernels with the most device time per step,
and, with --out, writes the same object to FILE.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..train import denoise, driver
from ..train.schedules import define_lr_schedule


def batch_for(opt: dict, recipe, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(step input, gt) of the config's shapes, seeded: the LR clip, or for
    the denoise recipe the noisy clip with its noise map."""
    d, s = opt["dataset"]["train"], opt["scale"]
    n, t, crop = d.get("batch_size", 4), opt["train"]["tempo_extent"], d.get("crop_size", 128)
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(rng.random((n, t, crop, crop, 3), dtype=np.float32)).to(dev)
    if isinstance(recipe.cfg, denoise.DenoiseTrainConfig):
        return denoise.noisy_input(recipe.cfg, gt, 0)[0], gt
    return torch.from_numpy(rng.random((n, t, crop // s, crop // s, 3), dtype=np.float32)).to(dev), gt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    opt = driver.load_config(args.config)
    recipe = driver.build_training(opt, dev)
    sched = define_lr_schedule(opt["train"]["generator"].get("lr_schedule"), recipe.cfg.lr)
    x, gt = batch_for(opt, recipe, dev)
    state = recipe.state

    phase_s = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}

    def step(timed: bool = False):
        # the work of recipe.step (vsr.apply_gradients), phase by phase
        def mark(name, t0):
            if timed:
                torch.cuda.synchronize()
                phase_s[name] += time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        loss, _ = recipe.loss_fn(state.params, x, gt)
        t0 = mark("forward", t0)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        t0 = mark("backward", t0)
        for group in state.opt.param_groups:
            group["lr"] = sched(state.step)
        state.opt.step()
        state.step += 1
        mark("optimizer", t0)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.iters * 1e3
    for _ in range(args.iters):
        step(timed=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()

    per_step = 1e-3 / args.iters  # profiler us over iters -> ms per step
    # device events, less the user annotations PyTorch draws on the device
    # timeline around work it also lists (Optimizer.step#Adam.step)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels) * per_step
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * per_step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res = {
        "card": card, "config": str(args.config), "recipe": type(recipe.cfg).__name__,
        "input_shape": list(x.shape), "gt_shape": list(gt.shape), "iters": args.iters,
        "step_ms": step_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
        "kernel_launches_per_step": len(kernels) / args.iters,
        "phase_ms": {k: v / args.iters * 1e3 for k, v in phase_s.items()},
        "top_kernels": [{"name": k[:120], "ms": v} for k, v in top],
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return res


if __name__ == "__main__":
    main()
