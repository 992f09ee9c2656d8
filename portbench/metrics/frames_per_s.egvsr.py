"""frames_per_s.egvsr (host clock): frames_per_s on the egvsr cells, the
reader of `metrics/frames_per_s.py` under a name of its own, so that it
keeps a bound from egvsr.vod's own spread (PERF.md §2)."""

from portbench.registry import load_metric

read = load_metric("frames_per_s").read
