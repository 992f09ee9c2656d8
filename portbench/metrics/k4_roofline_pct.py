"""k4_roofline_pct (device trace), layer kernels (ops/conv_stack.py): the
bound of the SRVGG body's 32 conv + bias + PReLU layers a chunk of 4
frames at 720p (one launch a layer, ops.conv_stack.launches grows by 32
a chunk), times the layers run in the traced window, over the device
time of the kernels named here."""

from portbench.counts import kernel_bound_s

KERNELS = ["conv_one_kernel"]
LAYER = [{"work": "conv_stack", "args": {"n": 4, "h": 720, "w": 1280, "layers": 1}, "count": 1}]


def read(run):
    if run.trace is None:
        return None
    n, t = run.trace.kernels(KERNELS)
    if not n or t <= 0:
        return None
    return 100.0 * kernel_bound_s(LAYER) * n / t
