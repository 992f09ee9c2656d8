"""Service-prefixed logging (reference counterpart: ad-hoc print wrappers,
e.g. src/upscale/fsrcnn_upscaler.py:17-18 and src/sharkshark/image_server/
image_pipeline.py:24-27)."""

from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s")
        )
        root = logging.getLogger("sharkshark_tpu_torch")
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"sharkshark_tpu_torch.{name}")
