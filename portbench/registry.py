"""Discovery by name: everything the harness runs is found from
`BENCHMARK.json` and the files of this folder.

- a cell: an entry of BENCHMARK.json's `workloads` (config, traffic, chips);
- a configuration: `configs/<config>.json`;
- a traffic mix: `traffic/<traffic>.json`, parameters that the one
  general source and runner read;
- a metric: `metrics/<name>.py`, a reader with `read(run) -> float | None`.
  The metrics of a cell are BENCHMARK.json's entries that list it under
  `workloads`, or that list no cells and move an end-to-end metric the
  cell reports.

A later configuration, mix, cell or metric is new files and new entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "ROOT", "NAME", "Cell", "load_benchmark", "load_cell", "load_metric", "cell_metrics"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _named(kind: str, name: str, base: Path, suffix: str) -> Path:
    if not NAME.match(name):
        raise KeyError(f"{kind} name {name!r} is not a valid name")
    path = base / f"{name}{suffix}"
    if not path.is_file():
        raise KeyError(f"unknown {kind} {name!r}: no {path.relative_to(base.parent)}")
    return path


def load_config(name: str, here: Path = HERE) -> dict:
    return _json(_named("configuration", name, here / "configs", ".json"))


def load_traffic(name: str, here: Path = HERE) -> dict:
    return _json(_named("traffic mix", name, here / "traffic", ".json"))


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that a cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    bench = bench if bench is not None else load_benchmark(here.parent)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = sorted(w["name"] for w in bench["workloads"])
        raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has {known}")
    e2e, layer = cell_metrics(bench, name)
    return Cell(name=name, config=load_config(entry["config"], here), traffic=load_traffic(entry["traffic"], here),
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=layer)


def load_metric(name: str, here: Path = HERE):
    """The reader module of metric `name`, loaded from its file (a name
    may hold dots, so it is loaded by path, not imported by name)."""
    path = _named("metric", name, here / "metrics", ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise KeyError(f"metric {name!r}: {path.name} has no read(run)")
    return mod
