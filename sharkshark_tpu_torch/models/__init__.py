from . import bsvd, egvsr, srvgg, torch_import

__all__ = ["bsvd", "egvsr", "srvgg", "torch_import"]
