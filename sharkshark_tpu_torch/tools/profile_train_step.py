"""Where the time of one training step goes, on one GPU.

    python -m sharkshark_tpu_torch.tools.profile_train_step --config configs/egvsr_derived.yml \\
        [--iters 8] [--out FILE]

Builds the config's recipe as the training driver does (its widths,
batch, T, crop and rates; TF32 at PyTorch's default), feeds it one seeded
random batch of the config's shapes already on the card (the step's cost
does not depend on the pixels), and measures the step twice, each on a
recipe of its own: eager (the recipe's plain step) and through the
driver's compiled step (its CUDA graph, captured at the second call and
replayed after).  Each runs a few steps to warm up, then `--iters`
steps, and the tool prints one JSON object with, for each route,
  - step_ms: device-synchronised host time per step,
  - host_ms: the host time until a call returns, on an idle device,
  - busy_ms: the sum of the device time of the kernels of one step (the
    profiler lists the kernels of a graph's replay too),
  - device_ms: CUDA events around --iters steps back to back, per step,
  - idle_share: 1 - busy_ms / step_ms,
  - kernel_launches_per_step (the profiler's),
  - top_kernels: the kernels with the most device time per step,
and for the eager step of a recipe with one loss (not the GAN)
  - phase_ms: the forward pass with the loss, the backward pass and the
    optimizer's update, each timed apart with the device synchronised
    around it (so they sum to more than step_ms, where they overlap);
with --out, it writes the same object to FILE.
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

from ..train import denoise, driver, vsr
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


def _profile_steps(step, iters: int) -> dict:
    """step() `iters` times back to back: host ms per synchronised step,
    host ms until a call returns on an idle device, device ms per step
    between CUDA events, and the profiler's kernels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    host = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()

    per_step = 1e-3 / iters  # profiler us over iters -> ms per step
    # device events, less the user annotations PyTorch draws on the device
    # timeline around work it also lists (Optimizer.step#Adam.step)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels) * per_step
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * per_step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"step_ms": step_ms, "host_ms": sorted(host)[len(host) // 2], "device_ms": device_ms,
            "busy_ms": busy_ms, "kernel_launches_per_step": len(kernels) / iters,
            "top_kernels": [{"name": k[:120], "ms": v} for k, v in top]}


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
    x, gt = batch_for(opt, recipe, dev)
    res = {"card": card, "config": str(args.config), "recipe": type(recipe.cfg).__name__,
           "input_shape": list(x.shape), "gt_shape": list(gt.shape), "iters": args.iters}

    if isinstance(recipe.state, vsr.TrainState):
        sched = define_lr_schedule(opt["train"]["generator"].get("lr_schedule"), recipe.cfg.lr)
        state = recipe.state
        phase_s = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}

        def eager(timed: bool = False):
            # the work of the recipe's eager step, phase by phase
            def mark(name, t0):
                if timed:
                    torch.cuda.synchronize()
                    phase_s[name] += time.perf_counter() - t0
                return time.perf_counter()

            t0 = time.perf_counter()
            vsr.set_rate(state.opt, sched(state.step))
            loss, _ = recipe.loss_fn(state.params, x, gt)
            t0 = mark("forward", t0)
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            t0 = mark("backward", t0)
            state.opt.step()
            state.step += 1
            mark("optimizer", t0)
    else:
        # the GAN: one call of its eager step, whose losses are its own
        def eager(timed: bool = False):
            recipe.step.eager(recipe.state, x, gt)

    graphed = driver.build_training(opt, dev)

    def graphs():
        graphed.step(graphed.state, x, gt)

    routes = {}
    for name, step in (("eager", eager), ("graphs", graphs)):
        for _ in range(3):  # the graphs: warm-up, capture, replay
            step()
        routes[name] = _profile_steps(step, args.iters)
    if isinstance(recipe.state, vsr.TrainState):
        for _ in range(args.iters):
            eager(timed=True)
        routes["eager"]["phase_ms"] = {k: v / args.iters * 1e3 for k, v in phase_s.items()}
    routes["graphs"]["graphs"] = graphed.step.num_graphs
    for r in routes.values():
        r["idle_share"] = 1.0 - r["busy_ms"] / r["step_ms"]
    res.update(routes)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return res


if __name__ == "__main__":
    main()
