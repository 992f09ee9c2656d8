"""The benchmark of sharkshark_tpu_torch: one cell, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (BENCHMARK.json, configs/, traffic/), builds the live
restream pipeline as the CLI does, warms it up, lets the source emit for
`--seconds` (the window), drains, then checks a seeded sample of the
delivered frames against the plain reference.  The last line of standard
output is the result, a JSON object; with --trace 0 its metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (read
from a torch.profiler trace of the window's end and the program's
spans).  It exits non-zero, and prints no result, without enough CUDA
devices or when JAX or the JAX package is loaded in this process.
"""

from __future__ import annotations

import time

T_START_NS = time.time_ns()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sharkshark_tpu")


def forbidden_modules(names) -> list[str]:
    """The names whose top-level part (before the first dot) is one of
    FORBIDDEN, compared as whole names: `sharkshark_tpu_torch` is not
    `sharkshark_tpu`."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def _set_environment(root: Path) -> None:
    """Caches inside the checkout at fixed paths, and no JAX pulled in by
    a library."""
    os.environ["SHARKSHARK_COMPILE_CACHE"] = str(root / "sharkshark_tpu_torch" / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "portbench" / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "portbench" / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_info() -> dict:
    """The card's name (torch) and power limit (nvidia-smi, where it runs)."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout.split("\n")[0]
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t_start_ns: int | None = None,
             after_build=None, log=print) -> dict:
    """One run of `cell`; returns the result object (the last line's)."""
    import torch

    from .accounting import account
    from .check import compare, psnr_db, select
    from .content import Scene
    from .live import run_pipeline
    from .reference.stream import Reference
    from .registry import ROOT, load_metric
    from .trace import Trace

    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        logs = run_pipeline(cell.config, cell.traffic, seed, seconds, work, device=device, trace=trace,
                            t_start_ns=t_start_ns, after_build=after_build)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    acct = account(cell.config["model"], logs.batch, logs.t0_ns, logs.t1_ns, logs.source, logs.captures,
                   logs.service, logs.delivered, logs.sink["arrivals"], logs.t_end_ns)
    tr = Trace(logs.trace_events, logs.trace_window, logs.host) if trace else None

    run = SimpleNamespace(acct=acct, logs=logs, trace=tr, config=cell.config, cell=cell)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    lat = acct.latencies_ms
    log(f"window: {acct.attempted} source frames due, {acct.failed} never delivered, "
        f"{acct.delivered_in_window} delivered inside it; latency samples {len(lat)}, "
        f"median {float(sorted(lat)[len(lat) // 2]) if len(lat) else float('nan'):.3f} ms; "
        f"set-up {logs.setup_s:.3f} s (warm-up {logs.warmup_s:.3f} s); skipped {logs.skipped_frames}; "
        f"the source opened the window {(logs.t0_ns - logs.source_ready_ns) / 1e6:.1f} ms after it was ready")

    log(_diagnostics(acct, logs))

    # the check, once the program's state is freed
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t = time.monotonic()
    picked = select(logs.sink, acct.sink_outputs)
    outs = [acct.sink_outputs[k] for k, _ in picked]
    c = cell.config
    scene = Scene(seed, *c["lr_shape"], pan=tuple(cell.traffic["pan"]), sigma=cell.traffic["noise_sigma"])
    timeline = _timeline(c["model"], logs, acct)
    ref = Reference(c, ROOT, torch.device(device)).outputs(scene, timeline, outs) if outs else []
    ok, checked = compare([f for _, f in picked], ref, c["limits"], acct.mismatched)
    log(f"check: {len(outs)} frames at sink indices {[k for k, _ in picked]} (timeline positions "
        f"{[o.position for o in outs]}) in {time.monotonic() - t:.1f} s; PSNR "
        f"{[round(psnr_db(f, r), 3) for (_, f), r in zip(picked, ref)]}")

    result = {"correct": bool(ok), "attempted": int(acct.attempted), "failed": int(acct.failed),
              "metrics": metrics, "device": {"count": cell.chips, "memory_peak_bytes": logs.memory_peak_bytes}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checked"] = checked
    return result


def _diagnostics(acct, logs) -> str:
    """One line for the reader of standard error: the latency's
    percentiles, how late the source wrote, the capture lag and the
    stages' mean spans over the window's micro-batches."""
    import numpy as np

    from .accounting import nearest_rank

    lat = acct.latencies_ms
    pct = {q: round(nearest_rank(lat, q), 1) for q in (50, 90, 95, 99, 100)} if len(lat) else {}
    due, written = logs.source[:, 0], logs.source[:, 1]
    win = (due >= logs.t0_ns) & (due < logs.t1_ns)
    late = (written[win] - due[win]) / 1e6 if win.any() else np.zeros(1)
    spans = {}
    for t, d in logs.spans:
        if t <= logs.t1_ns:
            for k in ("recoder.output", "upscaler.upscale", "upscaler.fetch", "upscaler.output", "streamer.send.queue"):
                if isinstance(d.get(k), float):
                    spans.setdefault(k, []).append(d[k] * 1e3)
    means = {k: round(sum(v) / len(v), 2) for k, v in spans.items()}
    return (f"latency ms by percentile {pct}; source late ms mean {late.mean():.2f} max {late.max():.2f}; "
            f"span means ms {means}")


def _timeline(model: str, logs, acct) -> list[int]:
    from .accounting import build_outputs

    return build_outputs(model, logs.captures, logs.service, logs.batch)[1].frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .registry import ROOT, load_benchmark, load_cell

    _set_environment(ROOT)
    cell = load_cell(args.workload, load_benchmark(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), this host has {n}", file=sys.stderr)
        return 2
    device_info = card_info()
    seed = args.seed & 0xFFFFFFFFFFFFFFFF

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(cell, seed, args.seconds, bool(args.trace), t_start_ns=T_START_NS, log=log)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: JAX or the JAX package is loaded in this process: {bad}", file=sys.stderr)
        return 3
    result["device"] = {**device_info, **result["device"]}
    result["checked"] = result.pop("checked")  # the numbers compared come last
    for name, v in result["checked"].items():
        print(f"checked {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
