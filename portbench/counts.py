"""Operations, bytes and bounds: the benchmark's frozen yardstick.

The bound arithmetic is a copy of the program's
`sharkshark_tpu_torch/tools/bench_tsm_conv.py::bound` (and the work
functions of bench_tsm_conv, bench_conv_stack and bench_backward_warp):
the least time the card could take is the larger of the bytes over the
memory rate and the operations over the peak rate of their type, each
input byte read once and each output byte written once.  The peaks are
NVIDIA's data sheet figures of the H100 SXM at 700 W.

A frame's operations for `step_mfu_pct` are counted by
torch.utils.flop_counter over the plain reference's forward
(reference/models.py) at the configuration's shapes, on the meta device.
"""

from __future__ import annotations

import functools

__all__ = ["PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "PEAK_BYTES", "bound_s", "tsm_conv_work", "conv_stack_work",
           "backward_warp_work", "kernel_bound_s", "frame_flops"]

PEAK_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def tsm_conv_work(t: int, h: int, w: int, c: int) -> tuple[int, int]:
    """K1: one bidirectional temporal-shift 3x3 conv of a (T, 1, H, W, C)
    bf16 chunk: x, the previous frame and the left fold slice read, the
    weights and bias read, out written."""
    fold = c // 8
    flops = 2 * 9 * c * c * t * h * w
    nbytes = 2 * (2 * t * h * w * c + h * w * c + h * w * fold + 9 * c * c + c)
    return flops, nbytes


def conv_stack_work(n: int, h: int, w: int, layers: int = 1, c: int = 64, with_bias: bool = True) -> tuple[int, int]:
    """K4: L conv + bias + PReLU layers at (n, h, w, 64) bf16: x and out
    once each, the bf16 weights and the float32 alphas and biases."""
    flops = layers * 2 * 9 * c * c * n * h * w
    nbytes = 2 * (n * h * w * c * 2) + layers * (9 * c * c * 2 + c * 4 * (2 if with_bias else 1))
    return flops, nbytes


FLOPS_PER_WARPED_VALUE = 15  # the clamps, floors, weights and three lerps, in float32


def backward_warp_work(n: int, h: int, w: int, c: int, x_bytes: int = 2, flow_bytes: int = 2) -> tuple[int, int]:
    """K3: one backward warp of x (n, h, w, c): x read and out written
    once, the flow read once, the one-byte skip flag."""
    values = n * h * w * c
    return FLOPS_PER_WARPED_VALUE * values, 2 * values * x_bytes + n * h * w * 2 * flow_bytes + 1


_WORK = {"tsm_conv": tsm_conv_work, "conv_stack": conv_stack_work, "backward_warp": backward_warp_work}
_PEAK = {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS}


def kernel_bound_s(launches: list[dict]) -> float:
    """The bound of a layer's work given as data: a list of
    {"work": <name in _WORK>, "args": {...}, "count": n, "peak": "bf16"|"f32"}."""
    total = 0.0
    for item in launches:
        flops, nbytes = _WORK[item["work"]](**item["args"])
        total += item.get("count", 1) * bound_s(flops, nbytes, _PEAK[item.get("peak", "bf16")])
    return total


@functools.lru_cache(maxsize=None)
def _frame_flops(model: str, lr_h: int, lr_w: int, num_conv: int, nb: int, weights: tuple[str, ...]) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import models as m
    from .registry import ROOT

    dev = torch.device("meta")
    nets = [m.Nets(m.load_state_dict(ROOT / w), dev) for w in weights]
    lr = torch.zeros((1, 3, lr_h, lr_w), device=dev)
    with FlopCounterMode(display=False) as counter:
        if model == "realesrgan":
            m.srvgg(nets[0], lr, num_conv)
            m.bsvd_clip(nets[1], torch.zeros((1, 4, lr_h, lr_w), device=dev))
        else:
            m.fnet(nets[0], lr, lr)
            m.srnet(nets[0], lr, torch.zeros((1, 48, lr_h, lr_w), device=dev), nb)
    return int(counter.get_total_flops())


def frame_flops(config: dict) -> int:
    """The plain reference's operations for one frame of the configuration
    (torch.utils.flop_counter over its forward on the meta device, with
    the configuration's weights files giving the shapes: its
    convolutions, 2 per multiply-add)."""
    h, w = config["lr_shape"]
    weights = tuple(config[k] for k in ("weights", "denoise_weights") if k in config)
    return _frame_flops(config["model"], h, w, config.get("srvgg", {}).get("num_conv", 0),
                        config.get("frnet", {}).get("nb", 0), weights)
