"""Resolution ladders of the production pipeline.

Parity with the reference's hard-coded tables: lr_level 0-5
(src/upscale/fsrcnn_upscaler.py:93-100) and hr_level 0-2
(src/sharkshark/pipeline.py:46-50). Shapes are (H, W).
"""

from __future__ import annotations

LR_LEVELS: tuple[tuple[int, int], ...] = (
    (360, 640),
    (540, 960),
    (630, 1120),
    (720, 1280),
    (900, 1600),
    (1080, 1920),
)

HR_LEVELS: tuple[tuple[int, int], ...] = (
    (1440, 2560),
    (1800, 3200),
    (2160, 3840),
)


def lr_shape_for_level(lr_level: int) -> tuple[int, int]:
    return LR_LEVELS[lr_level]


def hr_shape_for_level(hr_level: int) -> tuple[int, int]:
    return HR_LEVELS[hr_level]
