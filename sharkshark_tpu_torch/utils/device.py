"""Device selection for the port's entry points, and the cache of the
per-device constants its ops make (tap tables, blur weights, gather
indices)."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; a CUDA device on a host without CUDA
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def _leaves(value):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def device_cache(fn):
    """Memoise `fn`, which makes constant tensors on a device from
    hashable arguments: a copy from host memory on every call would make
    the host wait for the device's queue to drain.  The tensors are made
    outside inference mode, so that autograd may save them (a training
    step after an inference call in one process), and kept only when they
    are plain tensors: made while torch.export traces a function they are
    fake tensors, which a later eager call must not get, so such a call
    makes them anew and keeps nothing."""
    cache = {}

    @functools.wraps(fn)
    def cached(*args):
        hit = cache.get(args)
        if hit is not None:
            return hit
        with torch.inference_mode(False):
            value = fn(*args)
        if all(type(t) is torch.Tensor for t in _leaves(value)):
            cache[args] = value
        return value

    cached.cache_clear = cache.clear
    return cached
