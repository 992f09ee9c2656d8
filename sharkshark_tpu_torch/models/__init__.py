from . import bsvd, srvgg, torch_import

__all__ = ["bsvd", "srvgg", "torch_import"]
