from .levels import HR_LEVELS, LR_LEVELS, hr_shape_for_level, lr_shape_for_level
from .steps import (
    UpscaleSpec,
    egvsr_upscale_chunk,
    egvsr_upscale_step,
    flush_batch_denoise,
    init_denoise_state,
    upscale_batch_denoise,
    upscale_multi,
    upscale_single_denoise,
)
from .tile import tile_upscale
from .service import (
    BaseUpscalerService,
    EgvsrUpscalerService,
    EsrganUpscalerService,
    UpscalerQueueEntry,
)

__all__ = [
    "LR_LEVELS", "HR_LEVELS", "lr_shape_for_level", "hr_shape_for_level",
    "UpscaleSpec", "upscale_multi", "upscale_single_denoise", "upscale_batch_denoise",
    "flush_batch_denoise", "init_denoise_state", "egvsr_upscale_step", "egvsr_upscale_chunk",
    "tile_upscale", "UpscalerQueueEntry", "BaseUpscalerService", "EsrganUpscalerService", "EgvsrUpscalerService",
]
