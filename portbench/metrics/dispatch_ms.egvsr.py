"""dispatch_ms on the egvsr cells: the reader of `metrics/dispatch_ms.py`, under a name of
its own so that its end-to-end metric, `frames_per_s.egvsr`, keeps a
bound from egvsr.vod's own spread (PERF.md §2)."""

from portbench.registry import load_metric

read = load_metric("dispatch_ms").read
