from .nn import conv2d, pixel_shuffle, prelu, relu6
from .resize import resize
from .color import (
    blur,
    gaussian_kernel_2d,
    global_color_match,
    local_color_match,
    sharpen,
    to_float,
    to_uint8,
    to_yuv420,
)

__all__ = [
    "conv2d", "pixel_shuffle", "prelu", "relu6", "resize",
    "blur", "gaussian_kernel_2d", "global_color_match", "local_color_match",
    "sharpen", "to_float", "to_uint8", "to_yuv420",
]
