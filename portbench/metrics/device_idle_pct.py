"""device_idle_pct (device trace), layer device: the share of the traced
window in which no operation ran on the card, from the union of the
intervals of the trace's device operations (kernels, copies, sets), not
their sum."""


def read(run):
    if run.trace is None or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
