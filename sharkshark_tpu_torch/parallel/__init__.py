"""Multi-device serving (counterpart of the JAX package's parallel/):
a mesh of torch.devices driven from one process, and the sharded
versions of the serving steps."""

from ._bands import ShardedState, gather_state, shard_state
from .mesh import (
    Mesh,
    NamedSharding,
    P,
    batch_sharding,
    make_mesh,
    pad_batch,
    replicated,
    spatial_sharding,
)
from .sharded import (
    bsvd_radius,
    denoise_radius,
    egvsr_radius,
    make_sharded_denoise,
    make_sharded_denoise_flush,
    make_sharded_egvsr_step,
    make_sharded_upscale,
    sr_align,
    sr_radius,
    upscale_radius,
    width_sharding,
)

__all__ = [
    "make_mesh", "replicated", "batch_sharding", "spatial_sharding",
    "pad_batch", "P", "make_sharded_upscale",
    "make_sharded_denoise", "make_sharded_denoise_flush",
    "make_sharded_egvsr_step", "width_sharding",
    "Mesh", "NamedSharding", "ShardedState", "shard_state", "gather_state",
    "sr_radius", "sr_align", "bsvd_radius", "egvsr_radius", "upscale_radius", "denoise_radius",
]
