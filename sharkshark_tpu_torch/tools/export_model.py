"""Ahead-of-time export of a serving model step with torch.export
(counterpart of the JAX package's tools/export_model.py, the analogue of
the reference's ONNX path, src/upscale/model/egvsr/torch2onnx.py:74-170).

Exports one model function to a `.pt2` program that runs without the
Python model code, reloads it, checks it against the eager function on
the same input, and times it (host clock around synchronised
iterations) beside the eager function.  The hand-written kernels are torch
operators (`torch.ops.sharkshark.*`, ops/_library.py), so the program
holds them as calls: SRVGG's body as one K4 call for each group of the
service's default `conv_stack` layers, EGVSR's HR warp as a K3 call;
loading the program needs this package imported (which registers the
ops).  On the card the input and weights are bf16,
as the services run; with `--device cpu` float32, where each op runs its
plain version.

    python -m sharkshark_tpu_torch.tools.export_model --model srvgg --out saves/export/srvgg.pt2 \\
        --shape 1,720,1280,3 [--weights W.pth] [--speed-test --iters 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from collections import Counter

import torch

from .. import models
from ..models import egvsr, fsrcnn, srvgg, torch_import
from ..ops import conv_stack as cs
from ..ops import tsm_conv as tsm
from ..ops import warp as wp
from ..utils.device import resolve_device

__all__ = ["build", "main", "MODELS"]

MODELS = ("srvgg", "fsrcnn", "egvsr")


class _Step(torch.nn.Module):
    """A model function as the module torch.export traces; the weights are
    constants of the program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def build(model: str, shape: tuple[int, int, int, int], weights: str | None, device: torch.device):
    """(fn, example input) of `model` at `shape` (N, H, W, C) on `device`:
    srvgg.apply of general-x4v3 at the service's default conv_stack,
    fsrcnn.apply on one channel, or egvsr.infer_step from a zero state
    (its HR frame).  Seeded weights (torch.Generator seed 0) unless a
    reference-layout .pth is named."""
    n, h, w, c = shape
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator().manual_seed(0)
    sd = torch_import.load_state_dict(weights) if weights else None
    if model == "srvgg":
        cfg = srvgg.GENERAL_X4V3
        params = srvgg.from_torch(sd, cfg, device) if sd else srvgg.init_params(gen, cfg, device)
        params = models.cast_params(params, dtype)
        conv_stack = srvgg.resolve_conv_stack(cfg, None)

        def fn(x):
            return srvgg.apply(params, x, cfg=cfg, conv_stack=conv_stack)

        example = torch.zeros((n, h, w, c), dtype=dtype, device=device)
    elif model == "fsrcnn":
        params = fsrcnn.from_torch(sd, device) if sd else fsrcnn.init_params(gen, device)
        params = models.cast_params(params, dtype)

        def fn(x):
            return fsrcnn.apply(params, x)

        example = torch.zeros((n, h, w, 1), dtype=dtype, device=device)
    elif model == "egvsr":
        cfg = egvsr.config_from_torch(sd) if sd else egvsr.DEFAULT
        params = egvsr.from_torch(sd, cfg, device) if sd else egvsr.init_params(gen, cfg, device)
        params = models.cast_params(params, dtype)
        state = egvsr.init_recurrent_state(n, h, w, cfg, dtype, device)

        def fn(x):
            return egvsr.infer_step(params, state, x, cfg=cfg)[0]

        example = torch.zeros((n, h, w, c), dtype=dtype, device=device)
    else:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    return fn, example


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict[str, int]:
    return {"tsm_conv": tsm.launches, "backward_warp": wp.launches, "conv_stack": cs.launches}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.export_model")
    p.add_argument("--model", default="srvgg", choices=MODELS)
    p.add_argument("--weights", default=None, help="a reference-layout .pth (default: seeded weights)")
    p.add_argument("--shape", default="1,360,640,3", help="N,H,W,C of the input")
    p.add_argument("--out", default=None, help="write the program here (.pt2), then reload and check it")
    p.add_argument("--speed-test", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (bf16, the kernels) or cpu (float32, plain versions)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    shape = tuple(int(s) for s in args.shape.split(","))
    fn, example = build(args.model, shape, args.weights, dev)
    # inference only, as the services run; the program records no autograd
    with torch.no_grad():
        exported = torch.export.export(_Step(fn), (example,))
    out_meta = exported.graph_module.graph.find_nodes(op="output")[0].args[0][0].meta["val"]
    kernels = Counter(str(n.target) for n in exported.graph.nodes
                      if n.op == "call_function" and str(n.target).startswith("sharkshark."))
    print(f"exported {args.model}: in {tuple(example.shape)} {example.dtype} -> out {tuple(out_meta.shape)} "
          f"{out_meta.dtype}; kernel op calls {dict(kernels)}")
    res = {"model": args.model, "device": str(dev), "in_shape": list(example.shape),
           "out_shape": list(out_meta.shape), "kernel_ops": dict(kernels)}

    program = exported
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.export.save(exported, args.out)
        print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
        program = torch.export.load(args.out)
        with torch.no_grad():
            want = fn(example)
            before = _launches()
            got = program.module()(example)
            _sync(dev)
            after = _launches()
        err = (got.float() - want.float()).abs().max().item()
        # the same ops on the same input: float rounding at most (cuDNN may
        # pick another algorithm for a conv between the two runs)
        tol = (2.0**-7 if want.dtype == torch.bfloat16 else 1e-5) * max(want.float().abs().max().item(), 1.0)
        if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype or not err <= tol:
            raise RuntimeError(f"reloaded {args.out}: {tuple(got.shape)} {got.dtype}, max |err| {err} "
                               f"against eager {tuple(want.shape)} {want.dtype} (tolerance {tol})")
        res.update(out=args.out, bytes=os.path.getsize(args.out), max_abs_err=err,
                   launches={k: after[k] - before[k] for k in after})
        print(f"reload ok: output {tuple(got.shape)}, max |err| against eager {err:.3g}, "
              f"kernel launches {res['launches']}")

    if args.speed_test:
        def per_iter_ms(run):
            with torch.no_grad():
                run(example)
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    run(example)
                _sync(dev)
            return (time.perf_counter() - t0) / args.iters * 1000

        ms, eager_ms = per_iter_ms(program.module()), per_iter_ms(fn)
        res.update(ms=ms, fps=1000 / ms, eager_ms=eager_ms)
        print(f"speed: {ms:.3f} ms/iter ({1000 / ms:.1f} fps) @ {shape} on {dev}; the eager function "
              f"{eager_ms:.3f} ms/iter")
    return res


if __name__ == "__main__":
    main()
