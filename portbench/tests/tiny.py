"""A tiny ladder for running the harness on the CPU: the program's LR and
HR levels and the 720p60 source size shrunk, and the cells' configs
with the same shapes."""

from __future__ import annotations

import copy

LR = (32, 64)
OUT = (64, 128)


def shrink(monkeypatch) -> None:
    from sharkshark_tpu_torch import pipeline as pipeline_mod
    from sharkshark_tpu_torch.stream import grabber
    from sharkshark_tpu_torch.upscale import levels
    from sharkshark_tpu_torch.upscale import service as service_mod

    monkeypatch.setattr(service_mod, "LR_LEVELS", (LR,) * 6)
    monkeypatch.setattr(levels, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setattr(pipeline_mod, "HR_LEVELS", (OUT,) * 3)
    monkeypatch.setitem(grabber.QUALITY_RESOLUTION, "720p60", (LR[1], LR[0]))


def tiny_cell(name: str):
    from portbench.registry import load_cell

    cell = copy.deepcopy(load_cell(name))
    cell.config["lr_shape"] = list(LR)
    cell.config["output_shape"] = list(OUT)
    cell.traffic["check_frames"] = 4
    return cell
