import torch

from . import bsvd, egvsr, fsrcnn, rrdbnet, srvgg, torch_import, variants, zoo

__all__ = ["bsvd", "egvsr", "fsrcnn", "rrdbnet", "srvgg", "torch_import", "variants", "zoo", "cast_params"]


def cast_params(params, dtype: torch.dtype):
    """Cast every floating-point tensor of a parameter tree (dicts, lists
    and tuples of tensors) to `dtype`, the bf16 inference policy; other
    leaves pass through."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype) for v in params)
    if torch.is_tensor(params) and params.is_floating_point():
        return params.to(dtype)
    return params
