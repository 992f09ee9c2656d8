from .nn import conv2d, conv_transpose2d, depthwise_conv2d, leaky_relu, max_pool2, pad2d, pixel_shuffle, prelu, relu6, space_to_depth
from .resize import resize, resize_nchw, upsample_tecogan
from .warp import backward_warp, backward_warp_ac0, backward_warp_fast, grid_sample_bilinear
from .color import (
    blur,
    gaussian_kernel_2d,
    global_color_match,
    local_color_match,
    sharpen,
    sharpen_kernel_2d,
    to_float,
    to_uint8,
    to_yuv420,
)

__all__ = [
    "conv2d", "conv_transpose2d", "depthwise_conv2d", "leaky_relu", "max_pool2", "pad2d", "pixel_shuffle", "prelu", "relu6",
    "space_to_depth", "resize", "resize_nchw", "upsample_tecogan",
    "backward_warp", "backward_warp_ac0", "backward_warp_fast", "grid_sample_bilinear",
    "blur", "gaussian_kernel_2d", "global_color_match", "local_color_match",
    "sharpen", "sharpen_kernel_2d", "to_float", "to_uint8", "to_yuv420",
]
