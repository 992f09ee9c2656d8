"""The benchmark of sharkshark_tpu_torch: `python3 -m portbench.run --workload <cell> ...` (run.py)."""
