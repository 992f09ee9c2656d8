"""Parameter count, FLOP count and frames/s of a model (counterpart of
the JAX package's train/model_summary.py; reference metrics/
model_summary.py:15-63).

`profile_model` counts with torch.utils.flop_counter.FlopCounterMode,
which counts the multiply-adds of convolutions and matrix products
(2 FLOPs each) and nothing else; XLA's cost analysis, which the JAX
package reads, also counts elementwise work, so its figure is higher on
the same model.  A hand kernel's launch is not a torch operator and is
not counted.  `benchmark_fps` times the function compiled per shape, as
the JAX one times jax.jit(fn).
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

from .vsr import param_leaves

__all__ = ["count_params", "profile_model", "benchmark_fps"]


def count_params(params: Any) -> int:
    return sum(t.numel() for t in param_leaves(params))


def profile_model(fn: Callable, *example_args) -> dict:
    """{'flops': conv and matmul FLOPs of one fn(*example_args)}."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def _sync(out) -> None:
    leaf = out
    while isinstance(leaf, (list, tuple, dict)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def benchmark_fps(fn: Callable, *example_args, iters: int = 10) -> float:
    """Calls of the compiled fn(*example_args) per second of wall time,
    as the JAX function times jax.jit(fn): fn through a ShapeCache (on
    the card a CUDA graph replayed; eagerly on the CPU), timed after the
    calls that compile it (CAPTURE_CALL: one eager, one captured), with
    the device synchronised at both ends."""
    from ..upscale.jit_cache import CAPTURE_CALL, ShapeCache

    compiled = ShapeCache(fn)
    with torch.no_grad():
        for _ in range(CAPTURE_CALL):
            _sync(compiled(*example_args))
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = compiled(*example_args)
        _sync(out)
    return iters / (time.perf_counter() - t0)
