"""k1_roofline_pct (device trace), layer kernels (ops/tsm_conv.py): the
bound of BSVD-32's 16 temporal-shift convs a chunk of 4 frames at
720p (8 at C=64 on 360x640, 8 at C=128 on 180x320; counts.py), times the
chunks in the traced window, over the device time of the kernels named
here.  The chunks are the launches over 16 (ops.tsm_conv.launches grows
by 16 a chunk on the main path)."""

from portbench.counts import kernel_bound_s

KERNELS = ["tsm_conv_kernel"]
LAUNCHES_PER_CHUNK = 16
CHUNK = [
    {"work": "tsm_conv", "args": {"t": 4, "h": 360, "w": 640, "c": 64}, "count": 8},
    {"work": "tsm_conv", "args": {"t": 4, "h": 180, "w": 320, "c": 128}, "count": 8},
]


def read(run):
    if run.trace is None:
        return None
    n, t = run.trace.kernels(KERNELS)
    if not n or t <= 0:
        return None
    return 100.0 * kernel_bound_s(CHUNK) * (n / LAUNCHES_PER_CHUNK) / t
