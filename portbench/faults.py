"""Faults planted in the timed path, to show that the output check fails
them: each is a hook that run.run_cell calls once the pipeline is built
and warmed up, so the window's timed path runs it.

- `state_unchanged`: the stream's state never carries from one step to
  the next (BSVD's buffers reset before every dispatch; EGVSR's step
  hands back the state it was given);
- `half_left_out`: half of each micro-batch's outputs left out, the mean
  of the rest in their place;
- `answer_altered`: a quarter of every output frame inverted where the
  service hands it on.

(One chip: there is no exchange between chips to leave out.)

    python3 -m portbench.faults --workload <cell> --seeds 1,2 --seconds 5 [--faults a,b] [--json-out PATH]

runs the cell once a seed and fault, on the card, at the cell's own
sizes and load (a short window), and prints each run's compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["FAULTS"]


def state_unchanged(pipe) -> None:
    svc = pipe.upscaler
    if hasattr(svc, "_den_state"):
        inner = svc.upscale_dispatch

        def dispatch(frames):
            svc.reset_stream()  # the denoiser's state never carried from one step to the next
            return inner(frames)

        svc.upscale_dispatch = dispatch
    else:
        inner = svc._step
        svc._step = lambda p, s, f: (inner(p, s, f)[0], s)


def half_left_out(pipe) -> None:
    inner = pipe.upscaler._fetch

    def fetch(dev, n, start=0):
        out = np.array(inner(dev, n, start))
        half = max(1, len(out) // 2)
        out[half:] = out[:half].mean(axis=0).astype(np.uint8)
        return out

    pipe.upscaler._fetch = fetch


def answer_altered(pipe) -> None:
    inner = pipe.upscaler._fetch

    def fetch(dev, n, start=0):
        out = np.array(inner(dev, n, start))
        out[:, : out.shape[1] // 4] = 255 - out[:, : out.shape[1] // 4]
        return out

    pipe.upscaler._fetch = fetch


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out, "answer_altered": answer_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.faults", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from .registry import ROOT, load_benchmark, load_cell
    from .run import _set_environment, run_cell

    _set_environment(ROOT)
    cell = load_cell(args.workload, load_benchmark(ROOT))
    rows = []
    for name in args.faults.split(","):
        for s in args.seeds.split(","):
            res = run_cell(cell, int(s), args.seconds, False, after_build=FAULTS[name],
                           log=lambda m: print(m, file=sys.stderr, flush=True))
            row = {"workload": args.workload, "fault": name, "seed": int(s), "correct": res["correct"],
                   "checked": res["checked"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
