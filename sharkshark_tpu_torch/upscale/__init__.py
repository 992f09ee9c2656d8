from .levels import HR_LEVELS, LR_LEVELS, hr_shape_for_level, lr_shape_for_level
from .steps import (
    UpscaleSpec,
    flush_batch_denoise,
    init_denoise_state,
    upscale_batch_denoise,
    upscale_multi,
)
from .service import BaseUpscalerService, EsrganUpscalerService, UpscalerQueueEntry

__all__ = [
    "LR_LEVELS", "HR_LEVELS", "lr_shape_for_level", "hr_shape_for_level",
    "UpscaleSpec", "upscale_multi", "upscale_batch_denoise",
    "flush_batch_denoise", "init_denoise_state",
    "UpscalerQueueEntry", "BaseUpscalerService", "EsrganUpscalerService",
]
