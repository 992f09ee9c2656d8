"""From the run's stamps and logs to frames, carriers and end-to-end numbers.

The records (all times wall clock, ns):

- `source`: (n, 2) due and written time of each source frame, in order;
- `captures`: the Recoder's capture batches in order, (length, captured_at s);
- `service`: the entries that left the upscaler service in order, each
  (step, frames) of a micro-batch it ran, or (DRAIN, frames) for the
  denoise path's end-of-stream drain;
- `delivered`: the entries the Streamer sent on, in order, (step, frames);
- `arrivals`: the sink's arrival time of each frame it read, in order.

How outputs map to source frames.  The pipeline cuts capture batch b
(source frames [s_b, s_b + len_b)) into micro-batches of `batch` frames,
numbered in order over the whole stream (the entries' `step`, counted
also for micro-batches dropped later).  The service's timeline is the
frames of the micro-batches it ran, in order; on the denoise path a
micro-batch shorter than the service's batch is padded with copies of
its last frame, which take timeline positions too.  Then:

- `egvsr`: the output at timeline position q carries source frame
  timeline[q];
- `realesrgan` (BSVD's 16-frame lookahead, upscale/service.py and
  upscale/steps.py): the live output at position q blends the denoised
  frame of position q - 16 with the frame at q, so it carries the
  content of timeline[q - 16] (the first 16 outputs carry none); the
  drain's outputs are the denoised frames of the last 16 positions, each
  blended with itself, pads left out.

A source frame counts as delivered when the output that carries it
reached the sink; its latency runs from its due time at the source to
that arrival.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["DRAIN", "Output", "Timeline", "build_outputs", "Accounting", "account", "nearest_rank"]

DRAIN = -1
LOOKAHEAD = 16  # BSVD's SHIFT_NUM: buffered temporal-shift convs of the denoiser


@dataclass
class Output:
    """One output frame as the service emitted it: the source frame whose
    content it carries (None for the denoise path's first 16), the source
    frame of its own LR input, its timeline position, and on the denoise
    path the position of the denoised frame it blends (None on EGVSR's)."""

    carries: int | None
    lr: int
    position: int
    step: int
    den: int | None = None


@dataclass
class Timeline:
    frames: list[int] = field(default_factory=list)   # source index at each position
    real: list[bool] = field(default_factory=list)


def micro_batches(captures: list[tuple[int, float]], batch: int) -> list[range]:
    """The source-frame ranges of the micro-batches, by step."""
    out, start = [], 0
    for length, _ in captures:
        for j in range(0, length, batch):
            out.append(range(start + j, start + min(j + batch, length)))
        start += length
    return out


def build_outputs(kind: str, captures, service, batch: int) -> tuple[list[Output], Timeline]:
    """The service's outputs in emission order and its timeline."""
    steps = micro_batches(captures, batch)
    tl = Timeline()
    outputs: list[Output] = []
    padded = kind == "realesrgan"
    for step, n in service:
        if step == DRAIN:
            k = min(len(tl.frames), LOOKAHEAD)
            for p in range(len(tl.frames) - k, len(tl.frames)):
                if tl.real[p]:
                    outputs.append(Output(tl.frames[p], tl.frames[p], p, step, den=p))
            continue
        src = list(steps[step])
        if len(src) != n:
            raise ValueError(f"micro-batch {step} left the service with {n} frames, its capture has {len(src)}")
        first = len(tl.frames)
        tl.frames += src
        tl.real += [True] * n
        if padded and n < batch:
            tl.frames += [src[-1]] * (batch - n)
            tl.real += [False] * (batch - n)
        for q in range(first, first + n):
            if padded:
                carries = tl.frames[q - LOOKAHEAD] if q >= LOOKAHEAD else None
                outputs.append(Output(carries, tl.frames[q], q, step, den=q - LOOKAHEAD))
            else:
                outputs.append(Output(tl.frames[q], tl.frames[q], q, step))
    return outputs, tl


def nearest_rank(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q % of the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if not len(v):
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


@dataclass
class Accounting:
    attempted: int            # source frames due inside the window
    failed: int               # of those, never carried to the sink
    delivered_in_window: int  # source frames whose carrier reached the sink inside the window
    latencies_ms: np.ndarray  # per attempted frame, a dropped one above every delivered one
    capture_wait_ms: list     # per delivered frame: its batch's captured_at minus its due time
    sink_outputs: list        # Output of each sink frame, in order (None where the service emitted none)
    sink_arrivals: np.ndarray
    seconds: float
    mismatched: int = 0       # sink frames beyond or short of what the service's entries account for


def account(kind: str, batch: int, t0_ns: int, t1_ns: int, source, captures, service, delivered,
            arrivals, t_end_ns: int) -> Accounting:
    """Frames, failures and latencies of one run (see the module's text).
    t_end_ns: when the run stopped waiting for the sink, the latency
    given to a frame that never arrived."""
    source = np.asarray(source, np.int64).reshape(-1, 2)
    arrivals = np.asarray(arrivals, np.int64)
    outputs, _ = build_outputs(kind, captures, service, batch)
    by_step: dict[int, list[Output]] = {}
    for o in outputs:
        by_step.setdefault(o.step, []).append(o)
    # an entry whose frames the timeline does not account for is the
    # program's fault: counted, and its frames map to no output
    sink_outputs: list[Output | None] = []
    mismatched = 0
    for step, n in delivered:
        outs = by_step.get(step, [])
        mismatched += abs(len(outs) - n)
        sink_outputs += (outs + [None] * n)[:n]
    mismatched += abs(len(sink_outputs) - len(arrivals))
    arrival_of: dict[int, int] = {}
    for o, t in zip(sink_outputs, arrivals):
        if o is not None and o.carries is not None:
            arrival_of.setdefault(o.carries, int(t))
    # captured_at of each source frame's capture batch
    cap_of = np.empty(len(source), np.float64)
    start = 0
    for length, cap in captures:
        cap_of[start:start + length] = cap
        start += length
    due = source[:, 0]
    in_window = np.nonzero((due >= t0_ns) & (due < t1_ns))[0]
    lat, capw, failed, in_win = [], [], 0, 0
    for i in in_window:
        t = arrival_of.get(int(i))
        if t is None:
            failed += 1
            lat.append((t_end_ns - due[i]) / 1e6)
            continue
        lat.append((t - due[i]) / 1e6)
        capw.append(cap_of[i] * 1e3 - due[i] / 1e6)
        if t <= t1_ns:
            in_win += 1
    return Accounting(attempted=len(in_window), failed=failed, delivered_in_window=in_win,
                      latencies_ms=np.asarray(lat), capture_wait_ms=capw, sink_outputs=sink_outputs,
                      sink_arrivals=arrivals, seconds=(t1_ns - t0_ns) / 1e9, mismatched=mismatched)
