"""Quality metrics: PSNR (RGB or Y), tOF, LPIPS, per-sequence aggregation
and JSON output (counterpart of the JAX package's train/metrics.py;
reference metrics/metric_calculator.py:14-261 and the vendored LPIPS).

PSNR and tOF are the reference's formulas (BT.601 Y channel; the
end-point error of cv2's Farneback flow).  LPIPS is the net-lin AlexNet
model (5 feature taps, unit-normalised, a clamped 1x1 linear
calibration) on the port's convs, with weights from a torchvision
alexnet state dict and the LPIPS linear .pth; `LPIPS.minted()` loads the
repo's committed pair (weights/minted/lpips-{alex,lin}-derived.pth), a
self-consistent rank metric that is not LPIPS v0.1.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.torch_import import load_state_dict
from ..ops import conv2d
from ..utils import resolve_device

__all__ = ["rgb_to_ycbcr", "compute_psnr", "compute_tof", "LPIPS", "MetricCalculator"]


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """uint8 RGB HWC -> uint8 YCbCr (BT.601, the reference's
    data_utils.rgb_to_ycbcr)."""
    T = np.array(
        [
            [0.256788235294118, -0.148223529411765, 0.439215686274510],
            [0.504129411764706, -0.290992156862745, -0.367788235294118],
            [0.097905882352941, 0.439215686274510, -0.071427450980392],
        ],
        dtype=np.float64,
    )
    O = np.array([16, 128, 128], np.float64)
    out = img.astype(np.float64) @ T + O
    return out.clip(0, 255).round().astype(np.uint8)


def compute_psnr(true_img: np.ndarray, pred_img: np.ndarray, colorspace: str = "y") -> float:
    """PSNR on uint8 images (reference :208-225)."""
    if colorspace != "rgb":
        true_img = rgb_to_ycbcr(true_img)[..., 0]
        pred_img = rgb_to_ycbcr(pred_img)[..., 0]
    diff = true_img.astype(np.float64) - pred_img.astype(np.float64)
    rmse = np.sqrt(np.mean(diff**2))
    if rmse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / rmse))


def compute_tof(true_pre: np.ndarray, true_cur: np.ndarray, pred_pre: np.ndarray, pred_cur: np.ndarray) -> float:
    """Temporal optical-flow EPE between consecutive frames (reference
    :243-261)."""
    import cv2

    def gray(x):
        return cv2.cvtColor(x, cv2.COLOR_RGB2GRAY)

    args = (0.5, 3, 15, 3, 5, 1.2, 0)
    true_of = cv2.calcOpticalFlowFarneback(gray(true_pre), gray(true_cur), None, *args)
    pred_of = cv2.calcOpticalFlowFarneback(gray(pred_pre), gray(pred_cur), None, *args)
    diff = true_of - pred_of
    return float(np.mean(np.sqrt(np.sum(diff**2, axis=-1))))


# ---------------------------------------------------------------------------
# LPIPS (net-lin, alex)
# ---------------------------------------------------------------------------

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision alexnet.features: conv index -> (stride, padding); a 3x3/2
# max pool follows the first two taps
_ALEX_CONVS = {0: (4, 2), 3: (1, 2), 6: (1, 1), 8: (1, 1), 10: (1, 1)}

_MINTED_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "weights", "minted")
MINTED_ALEX_PATH = os.path.abspath(os.path.join(_MINTED_DIR, "lpips-alex-derived.pth"))
MINTED_LIN_PATH = os.path.abspath(os.path.join(_MINTED_DIR, "lpips-lin-derived.pth"))


class LPIPS:
    """net-lin AlexNet LPIPS distance (reference LPIPS/models/
    networks_basic.py PNetLin + pretrained_networks.alexnet) on `device`."""

    def __init__(self, alexnet_sd_path: str, linear_sd_path: str, device: str | torch.device = "cuda"):
        if not (os.path.exists(alexnet_sd_path) and os.path.exists(linear_sd_path)):
            raise FileNotFoundError(
                "LPIPS needs torchvision alexnet weights and the LPIPS "
                f"linear weights ({alexnet_sd_path}, {linear_sd_path})"
            )
        self.device = resolve_device(device)
        alex = load_state_dict(alexnet_sd_path)
        lin = load_state_dict(linear_sd_path)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.convs = {
            i: (t(alex[f"features.{i}.weight"].transpose(2, 3, 1, 0)), t(alex[f"features.{i}.bias"]))
            for i in _ALEX_CONVS
        }
        # 1x1 linears as (C, 1), clamped at 0 as the reference does
        self.lins = [t(lin[f"lin{i}.model.1.weight"][:, :, 0, 0].T).clamp(min=0) for i in range(5)]
        self.shift = torch.tensor(_SHIFT, device=self.device)
        self.scale = torch.tensor(_SCALE, device=self.device)
        # written into every metrics JSON (MetricCalculator.save): minted
        # values are a rank metric, not comparable to LPIPS v0.1
        minted = (
            os.path.abspath(alexnet_sd_path) == MINTED_ALEX_PATH
            and os.path.abspath(linear_sd_path) == MINTED_LIN_PATH
        )
        self.provenance = "minted" if minted else "ingested"

    @classmethod
    def minted(cls, device: str | torch.device = "cuda") -> "LPIPS":
        """LPIPS from the committed minted backbone and calibration."""
        return cls(MINTED_ALEX_PATH, MINTED_LIN_PATH, device)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (N, H, W, 3) normalised -> the 5 feature taps (NHWC)."""
        taps = []
        y = x
        for i, (stride, pad) in _ALEX_CONVS.items():
            w, b = self.convs[i]
            y = torch.relu(conv2d(y, w, b, stride=stride, padding=pad))
            taps.append(y)
            if i in (0, 3):
                y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        return taps

    def __call__(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0/img1: (N, H, W, 3) in [-1, 1] on self.device; returns the
        (N,) distances."""
        f0 = self._features((img0 - self.shift) / self.scale)
        f1 = self._features((img1 - self.shift) / self.scale)
        total = 0.0
        for a, b, lin in zip(f0, f1, self.lins):
            a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-10)
            total = total + ((a - b) ** 2 @ lin).mean(dim=(1, 2))[:, 0]
        return total


class MetricCalculator:
    """Per-sequence metric aggregation and JSON output (reference
    metric_calculator.py:14-100,204-230)."""

    def __init__(self, metrics: list[str] = ("PSNR",), psnr_colorspace: str = "y", lpips: LPIPS | None = None):
        self.metrics = list(metrics)
        self.psnr_colorspace = psnr_colorspace
        self.lpips = lpips
        self.reset()

    def reset(self) -> None:
        self.seq_results: "OrderedDict[str, dict]" = OrderedDict()

    def _lpips(self, tru: np.ndarray, prd: np.ndarray) -> float:
        if self.lpips is None:
            raise RuntimeError("LPIPS weights not configured")

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.lpips.device, torch.float32)[None] * 2 / 255.0 - 1.0

        with torch.no_grad():
            return float(self.lpips(t(tru), t(prd))[0])

    def compute_sequence_metrics(self, seq_idx: str, true_seq: np.ndarray, pred_seq: np.ndarray) -> dict:
        """true_seq/pred_seq: (T, H, W, 3) uint8."""
        per_metric: dict[str, list[float]] = {m: [] for m in self.metrics}
        for t in range(len(true_seq)):
            tru, prd = true_seq[t], pred_seq[t]
            h = min(tru.shape[0], prd.shape[0])
            w = min(tru.shape[1], prd.shape[1])
            tru, prd = tru[:h, :w], prd[:h, :w]
            for m in self.metrics:
                if m == "PSNR":
                    per_metric[m].append(compute_psnr(tru, prd, self.psnr_colorspace))
                elif m == "LPIPS":
                    per_metric[m].append(self._lpips(tru, prd))
                elif m == "tOF" and t > 0:
                    # Farneback needs equal-sized pairs: the previous frames
                    # carry the same crop
                    per_metric[m].append(
                        compute_tof(true_seq[t - 1][:h, :w], tru, pred_seq[t - 1][:h, :w], prd)
                    )
        avg = {m: float(np.mean(v)) for m, v in per_metric.items() if v}
        self.seq_results[seq_idx] = avg
        return avg

    def average(self) -> dict[str, float]:
        out = {}
        for m in self.metrics:
            vals = [r[m] for r in self.seq_results.values() if m in r]
            if vals:
                out[m] = float(np.mean(vals))
        return out

    def save(self, path: str, label: str = "average") -> None:
        data = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
        data[label] = {"sequences": self.seq_results, "average": self.average()}
        if "LPIPS" in self.metrics and self.lpips is not None:
            data[label]["lpips_weights"] = self.lpips.provenance
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
