"""k3_roofline_pct (device trace), layer kernels (ops/warp.py): the bound
of one backward warp of EGVSR's 2880x5120 bf16 HR frame with a bf16 flow,
written as space-to-depth 4, a frame (float32 arithmetic: 67 TFLOP/s;
ops.warp.launches grows by one a frame), times the frames in the traced
window, over the device time of the kernels named here."""

from portbench.counts import kernel_bound_s

KERNELS = ["backward_warp_kernel"]
FRAME = [{"work": "backward_warp", "args": {"n": 1, "h": 2880, "w": 5120, "c": 3}, "count": 1, "peak": "f32"}]


def read(run):
    if run.trace is None:
        return None
    n, t = run.trace.kernels(KERNELS)
    if not n or t <= 0:
        return None
    return 100.0 * kernel_bound_s(FRAME) * n / t
