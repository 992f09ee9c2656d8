"""device_idle_pct on the egvsr cells: the reader of `metrics/device_idle_pct.py`, under a name of
its own so that its end-to-end metric, `frames_per_s.egvsr`, keeps a
bound from egvsr.vod's own spread (PERF.md §2)."""

from portbench.registry import load_metric

read = load_metric("device_idle_pct").read
