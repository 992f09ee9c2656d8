"""VGG19 feature extractor for the perceptual (feature) loss (counterpart
of the JAX package's train/vgg.py; reference models/networks/vgg_nets.py
VGGFeatureExtractor, used by VSRGANModel.set_criterion,
vsrgan_model.py:98-103).

Runs torchvision's VGG19 `.features` stack on ImageNet-normalised input
and returns the activations at the requested layer indices (default
[8, 17, 26, 35] = relu2_2 / relu3_4 / relu4_4 / relu5_4).  The weights
come from a torchvision vgg19 state dict, by path or as a dict: none is
in the repository and none is downloaded, so the driver builds the
extractor only when the config's train.feature_crit.vgg_weights names a
file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.torch_import import load_state_dict
from ..ops import conv2d, max_pool2
from ..utils import resolve_device

__all__ = ["VGG19_LAYERS", "VGGFeatureExtractor"]

# torchvision vgg19.features: conv indices and channel plan
# (M = max pool position)
VGG19_LAYERS = [
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), (16, 256), "M",
    (19, 512), (21, 512), (23, 512), (25, 512), "M",
    (28, 512), (30, 512), (32, 512), (34, 512), "M",
]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGGFeatureExtractor:
    """weights: a torchvision vgg19 state dict, as a path or a dict of
    arrays or tensors; its convs are held HWIO on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, weights, feature_layers=(8, 17, 26, 35), device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        sd = weights if isinstance(weights, dict) else load_state_dict(weights)
        self.feature_layers = set(feature_layers)
        self.max_layer = max(feature_layers)
        self.convs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        for entry in VGG19_LAYERS:
            if entry == "M":
                continue
            i, _ = entry
            w = torch.as_tensor(np.asarray(sd[f"features.{i}.weight"], np.float32))
            b = torch.as_tensor(np.asarray(sd[f"features.{i}.bias"], np.float32))
            self.convs[i] = (w.permute(2, 3, 1, 0).contiguous().to(dev), b.to(dev))  # OIHW -> HWIO
        self.mean = torch.tensor(_MEAN, device=dev)
        self.std = torch.tensor(_STD, device=dev)

    def __call__(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, 3) in [0, 1] -> the feature maps at
        self.feature_layers, in order (the ImageNet normalisation applied
        here, as the reference's registered mean and std)."""
        y = (x - self.mean) / self.std
        feats = []
        idx = 0  # torchvision's sequential index
        for entry in VGG19_LAYERS:
            if idx > self.max_layer:
                break
            if entry == "M":
                y = max_pool2(y)
                if idx in self.feature_layers:
                    feats.append(y)
                idx += 1
                continue
            y = conv2d(y, *self.convs[entry[0]], padding=1)
            if idx in self.feature_layers:
                feats.append(y)
            idx += 1
            y = torch.relu(y)
            if idx in self.feature_layers:
                feats.append(y)
            idx += 1
        return feats
