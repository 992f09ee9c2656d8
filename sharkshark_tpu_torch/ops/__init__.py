from .nn import conv2d, leaky_relu, max_pool2, pad2d, pixel_shuffle, prelu, relu6, space_to_depth
from .resize import resize, upsample_tecogan
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
    "conv2d", "leaky_relu", "max_pool2", "pad2d", "pixel_shuffle", "prelu", "relu6",
    "space_to_depth", "resize", "upsample_tecogan",
    "blur", "gaussian_kernel_2d", "global_color_match", "local_color_match",
    "sharpen", "to_float", "to_uint8", "to_yuv420",
]
