"""Device meshes for the multi-device serving paths (counterpart of the
JAX package's parallel/mesh.py).

One process drives every device, as the JAX package's single controller
does.  A `Mesh` is a ("data", "spatial") array of torch.devices:

- "data"    - batch data parallelism (the micro-batch of upscale_multi),
- "spatial" - width sharding of frames, each shard with a halo of
              columns on each side (parallel/sharded.py).

A mesh may name one device more than once: `[torch.device("cpu")] * 8`
is the counterpart of the JAX tests' eight virtual CPU devices, and
`[cuda:0] * 4` runs four shards one after another on one card.
`make_mesh(n)` without `devices` takes n distinct CUDA devices and raises
when the host has fewer; nothing falls back to the CPU.

`replicated`, `batch_sharding`, `spatial_sharding` and `P` describe where
a tensor's parts live, as NamedSharding and PartitionSpec do in JAX: the
layouts the sharded factories split into (parameters replicated, frames
batch over "data" and W over "spatial", or W over both).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Mesh", "NamedSharding", "make_mesh", "replicated", "batch_sharding", "spatial_sharding",
           "pad_batch", "P"]

AXES = ("data", "spatial")


class Mesh:
    """A data x spatial grid of torch.devices; a device may repeat."""

    axis_names = AXES

    def __init__(self, rows) -> None:
        """rows: one list of devices per data index, `spatial` long each."""
        rows = [[torch.device(d) for d in row] for row in rows]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty data x spatial grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def device_list(self) -> list[torch.device]:
        """Every device, data-major: index d * spatial + s."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"


class P(tuple):
    """PartitionSpec: one entry per tensor axis, the mesh axis (or tuple
    of axes) it is split over, or None where it is whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: P


def make_mesh(
    n_devices: int | None = None,
    *,
    data: int | None = None,
    spatial: int = 1,
    devices=None,
) -> Mesh:
    """Build a ("data", "spatial") mesh.  With only `n_devices` given, all
    of them go on the data axis.  Without `devices` it takes the first
    n_devices distinct CUDA devices (all of them when n_devices is None)."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = n_devices or avail or 1
        if avail < want:
            raise ValueError(
                f"make_mesh needs {want} devices but this host exposes only {avail} CUDA device(s). "
                f"Name the devices instead: make_mesh(devices=[torch.device('cpu')] * {want}, ...) "
                "repeats the CPU (what tests/test_torch_parallel.py does), and "
                f"[torch.device('cuda:0')] * {want} runs the shards one after another on one card.")
        devices = [torch.device("cuda", i) for i in range(want)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % spatial != 0:
            raise ValueError(
                f"{n} devices do not split evenly over spatial={spatial}; pass data= explicitly or pick "
                "a spatial axis dividing the device count.")
        data = n // spatial
    if data * spatial != n:
        raise ValueError(f"mesh shape data={data} x spatial={spatial} != {n} devices")
    return Mesh([devices[d * spatial : (d + 1) * spatial] for d in range(data)])


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC frames: batch over 'data', W over 'spatial' (no split when the
    spatial axis has size 1)."""
    return NamedSharding(mesh, P("data", None, "spatial", None))


def spatial_sharding(mesh: Mesh) -> NamedSharding:
    """NHWC frames: W split over BOTH axes, for a single stream with no
    batch to split."""
    return NamedSharding(mesh, P(None, None, AXES, None))


def pad_batch(n: int, mesh: Mesh) -> int:
    """Smallest batch >= n divisible by the data axis."""
    d = mesh.shape["data"]
    return math.ceil(n / d) * d
