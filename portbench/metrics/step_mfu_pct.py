"""step_mfu_pct (device trace), layer model step: the plain reference's
operations a frame (counts.frame_flops, by torch.utils.flop_counter at
the cell's shapes) times the frames whose steps ran inside the traced
window, over the seconds in which the card ran some operation there
(the union of the trace's device intervals), as a share of 989 TFLOP/s
(bf16, H100 SXM).  The frames are those of the service's fetches that
ended inside the traced window: a fetch waits for its step's device
work, so a step is counted when it is done (at most one micro-batch off
at either end of the window)."""

from portbench.counts import PEAK_BF16_FLOPS, frame_flops


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    a, b = run.trace.window
    frames = sum(n for t, n in run.logs.fetched if a <= t < b)
    if frames <= 0:
        return None
    return 100.0 * frame_flops(run.config) * frames / run.trace.busy_s / PEAK_BF16_FLOPS
