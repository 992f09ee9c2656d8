"""Import torch `.pth` checkpoints as flat numpy dicts in NHWC/HWIO layout.

A copy of the JAX package's loader, so that both packages read a
checkpoint into identical arrays, plus `to_tensors`, which moves such a
nested dict onto a device.  Covers the checkpoint dialects the reference
consumes:

- plain state dicts and {'params': ...} / {'params_ema': ...} wrappers
  (RealESRGAN releases; reference model/realesrgan/factory.py:140-170)
- DNI dual-checkpoint blending for denoise-strength control
  (reference factory.py:152-157)
- BSVD's `base_model.nets_list.{0,1}.` split + `net.` -> conv remapping
  (reference model/bsvd/model.py:8-20,487-499)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "load_state_dict",
    "dni_blend",
    "conv_from_torch",
    "conv_transpose_from_torch",
    "prelu_from_torch",
    "subdict",
    "to_tensors",
    "conv_to_torch",
    "cpu_state_dict",
]


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch checkpoint into a flat {name: float32 ndarray} dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for wrapper in ("params_ema", "params", "state_dict", "model"):
            if wrapper in ckpt and isinstance(ckpt[wrapper], dict):
                ckpt = ckpt[wrapper]
                break
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in ckpt.items()}


def dni_blend(
    sd_a: Mapping[str, np.ndarray], sd_b: Mapping[str, np.ndarray], alpha: float
) -> dict[str, np.ndarray]:
    """Deep network interpolation: alpha * a + (1 - alpha) * b per tensor."""
    return {k: alpha * sd_a[k] + (1.0 - alpha) * sd_b[k] for k in sd_a}


def subdict(sd: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """Select keys starting with `prefix`, stripping it."""
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def conv_from_torch(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """torch Conv2d (O, I, kh, kw) -> {'w': HWIO, 'b': (O,)?}."""
    w = np.transpose(sd[prefix + "weight"], (2, 3, 1, 0)).copy()
    out = {"w": w}
    if prefix + "bias" in sd:
        out["b"] = sd[prefix + "bias"].copy()
    return out


def conv_transpose_from_torch(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """torch ConvTranspose2d -> {'w': (I, O, kh, kw) as stored, 'b': (O,)?}:
    ops.conv_transpose2d takes torch's own layout, so unlike the JAX
    package's import nothing is flipped or transposed."""
    out = {"w": sd[prefix + "weight"].copy()}
    if prefix + "bias" in sd:
        out["b"] = sd[prefix + "bias"].copy()
    return out


def prelu_from_torch(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"alpha": sd[prefix + "weight"].copy()}


def to_tensors(tree, device="cpu", dtype=torch.float32):
    """Map the numpy-array (or tensor) leaves of a nested dict/list to
    tensors of `dtype` on `device`."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device, dtype) for v in tree]
    t = tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))
    return t.to(device=device, dtype=dtype)


def conv_to_torch(p: Mapping[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    """The inverse of conv_from_torch: {'w': HWIO, 'b'?} -> torch Conv2d's
    `prefix`weight (O, I, kh, kw) and `prefix`bias."""
    out = {prefix + "weight": p["w"].permute(3, 2, 0, 1)}
    if "b" in p:
        out[prefix + "bias"] = p["b"]
    return out


def cpu_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A state dict of contiguous CPU float32 tensors, as torch.save
    writes a checkpoint."""
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}
