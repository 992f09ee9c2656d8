"""The control's precision: the reference with every conv's input and
weight rounded to float8 e4m3 under a per-tensor scale (amax to 448),
the step below the configuration's bfloat16 that a later change could
be tempted to take.  Everything else stays in float32."""

from __future__ import annotations

import torch

__all__ = ["fp8_e4m3"]

E4M3_MAX = 448.0


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
