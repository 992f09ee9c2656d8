"""What decides `correct`: frames that the timed path delivered to the
sink, against the plain reference at the same sizes.

The sink keeps a sample of the frames it read, drawn from the seed
(reservoir sampling, ffmpeg/fake_ffmpeg.py).  Each kept frame is mapped to the output it is
(accounting.py): its timeline position and the source frames it carries.
The reference works each one out again (reference/stream.py) and the
comparison reads, over the compared frames, the worst frame's PSNR
against the reference (dB, over all pixels and channels of the uint8
frame).  `psnr_min_db` has to reach the configuration's limit (a floor:
the program reads above it, the float8 control below; the readings it
was set from are in PERF.md), and no frame that reached the sink may be
one the service's entries do not account for (`frames_mismatched`, 0).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["psnr_db", "select", "compare"]


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two uint8 frames, 99.0 where they are equal."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * math.log10(255.0**2 / mse)


def select(sink: dict, sink_outputs: list) -> list[tuple[int, np.ndarray]]:
    """(sink index, frame) of the kept frames that carry a source frame's
    content."""
    return [(int(k), f) for k, f in zip(sink["kept_idx"], sink["kept"])
            if 0 <= k < len(sink_outputs) and sink_outputs[k] is not None and sink_outputs[k].carries is not None]


def compare(program: list[np.ndarray], reference: list[np.ndarray], limits: dict,
            mismatched: int = 0) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of the compared frames:
    at least one compared, none of the sink's frames unaccounted for
    (accounting.py), and the worst frame's PSNR at its limit or above."""
    psnr = [psnr_db(p, r) for p, r in zip(program, reference)]
    checked = {
        "frames_compared": {"value": len(psnr), "limit": 1},
        "frames_mismatched": {"value": int(mismatched), "limit": 0},
        "psnr_min_db": {"value": min(psnr) if psnr else 0.0, "limit": limits["psnr_min_db"]},
    }
    ok = len(psnr) >= 1 and mismatched == 0 and checked["psnr_min_db"]["value"] >= limits["psnr_min_db"]
    return ok, checked
