"""FSRCNN super-resolution core, single channel (counterpart of the JAX
package's models/fsrcnn.py; reference src/upscale/model/fsrcnn/model.py:6-72).

Feature extraction 5x5 -> shrink 1x1 -> 4 mapping 3x3 -> expand 1x1 ->
9x9 transposed-conv upscale, PReLU throughout.  Parameters are a plain
dict of tensors in the JAX package's pytree layout (convs HWIO), except
the deconv, which keeps torch's own (I, O, kh, kw) layout unflipped
(ops.conv_transpose2d).  The JAX package runs the mapping stack lane-
folded on a TPU (ops/lanefold.py), an exact re-layout of the same convs;
here they are the plain convs.

RGB inputs ride the batch dimension, as the reference service does
(fsrcnn_upscaler.py:293-297): `apply_rgb`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import conv2d, conv_transpose2d, prelu
from .torch_import import (
    conv_from_torch, conv_to_torch, conv_transpose_from_torch, cpu_state_dict, prelu_from_torch, to_tensors,
)

__all__ = ["D", "S", "M", "init_params", "apply", "apply_rgb", "from_torch", "from_jax", "to_torch"]

D, S, M = 56, 12, 4  # feature dim, shrink dim, mapping depth


def init_params(generator: torch.Generator, device: str | torch.device = "cpu") -> dict:
    """Random weights drawn from `generator` (on the CPU, then moved to
    `device`), the reference's scheme: normal with std sqrt(2 / (out_ch *
    k * k)) for the convs, std 0.001 for the deconv, zero biases, PReLU
    0.25.  The deconv's shape does not depend on the upscale factor."""

    def conv(kh, kw, i, o):
        w = torch.randn((kh, kw, i, o), generator=generator) * math.sqrt(2.0 / (o * kh * kw))
        return {"w": w, "b": torch.zeros(o)}

    def act(c):
        return {"alpha": torch.full((c,), 0.25)}

    params = {
        "feat": conv(5, 5, 1, D), "feat_act": act(D),
        "shrink": conv(1, 1, D, S), "shrink_act": act(S),
        "map": [conv(3, 3, S, S) for _ in range(M)], "map_act": [act(S) for _ in range(M)],
        "expand": conv(1, 1, S, D), "expand_act": act(D),
        "deconv": {"w": torch.randn((D, 1, 9, 9), generator=generator) * 0.001, "b": torch.zeros(1)},
    }
    return to_tensors(params, device)


def apply(params: dict, x: torch.Tensor, *, factor: int = 4) -> torch.Tensor:
    """x: (N, H, W, 1) in [0, 1] -> (N, H*f, W*f, 1)."""
    y = prelu(conv2d(x, params["feat"]["w"], params["feat"].get("b"), padding=2), params["feat_act"]["alpha"])
    y = prelu(conv2d(y, params["shrink"]["w"], params["shrink"].get("b")), params["shrink_act"]["alpha"])
    for conv_p, act_p in zip(params["map"], params["map_act"]):
        y = prelu(conv2d(y, conv_p["w"], conv_p.get("b"), padding=1), act_p["alpha"])
    y = prelu(conv2d(y, params["expand"]["w"], params["expand"].get("b")), params["expand_act"]["alpha"])
    return conv_transpose2d(y, params["deconv"]["w"], params["deconv"].get("b"), stride=factor, padding=4,
                            output_padding=factor - 1)


def apply_rgb(params: dict, x: torch.Tensor, *, factor: int = 4) -> torch.Tensor:
    """x: (N, H, W, C) -> (N, H*f, W*f, C), each channel through the
    single-channel net as its own image: (N, H, W, C) -> (N*C, H, W, 1)."""
    n, h, w, c = x.shape
    y = apply(params, x.permute(0, 3, 1, 2).reshape(n * c, h, w, 1), factor=factor)
    return y.reshape(n, c, h * factor, w * factor).permute(0, 2, 3, 1)


def from_torch(sd: dict[str, np.ndarray], device: str | torch.device = "cpu") -> dict:
    """The reference checkpoint's module names (model.py:6-72) into the
    pytree."""
    return to_tensors({
        "feat": conv_from_torch(sd, "feature_extraction.0."),
        "feat_act": prelu_from_torch(sd, "feature_extraction.1."),
        "shrink": conv_from_torch(sd, "shrink.0."),
        "shrink_act": prelu_from_torch(sd, "shrink.1."),
        "map": [conv_from_torch(sd, f"map.{2 * i}.") for i in range(M)],
        "map_act": [prelu_from_torch(sd, f"map.{2 * i + 1}.") for i in range(M)],
        "expand": conv_from_torch(sd, "expand.0."),
        "expand_act": prelu_from_torch(sd, "expand.1."),
        "deconv": conv_transpose_from_torch(sd, "deconv."),
    }, device)


def to_torch(params: dict) -> dict[str, torch.Tensor]:
    """The inverse of from_torch: a CPU float32 state dict in the
    reference's key layout."""
    sd = {
        **conv_to_torch(params["feat"], "feature_extraction.0."),
        "feature_extraction.1.weight": params["feat_act"]["alpha"],
        **conv_to_torch(params["shrink"], "shrink.0."),
        "shrink.1.weight": params["shrink_act"]["alpha"],
        **conv_to_torch(params["expand"], "expand.0."),
        "expand.1.weight": params["expand_act"]["alpha"],
        "deconv.weight": params["deconv"]["w"],
    }
    for i, (conv_p, act_p) in enumerate(zip(params["map"], params["map_act"])):
        sd.update(conv_to_torch(conv_p, f"map.{2 * i}."))
        sd[f"map.{2 * i + 1}.weight"] = act_p["alpha"]
    if "b" in params["deconv"]:
        sd["deconv.bias"] = params["deconv"]["b"]
    return cpu_state_dict(sd)


def from_jax(np_params: dict, device: str | torch.device = "cpu") -> dict:
    """The JAX package's FSRCNN pytree (leaves as numpy arrays) as tensors:
    its deconv weight, stored flipped and HWIO, goes back to (I, O, kh,
    kw) unflipped."""
    params = dict(np_params)
    dw = np.asarray(np_params["deconv"]["w"])
    params["deconv"] = {**np_params["deconv"], "w": np.ascontiguousarray(np.transpose(dw[::-1, ::-1], (2, 3, 0, 1)))}
    return to_tensors(params, device)
