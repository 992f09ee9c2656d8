from . import bsvd, egvsr, fsrcnn, rrdbnet, srvgg, torch_import, zoo

__all__ = ["bsvd", "egvsr", "fsrcnn", "rrdbnet", "srvgg", "torch_import", "zoo"]
