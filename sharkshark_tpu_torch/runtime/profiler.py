"""Hierarchical tick profiler, API-compatible with the reference's
src/util/profiler.py:3-27: named start/end regions with running averages
in `.data`, plus `set()` gauges. One instance travels with each queue
entry through every pipeline stage (reference pipeline.py:143-148) and is
dumped as JSON every few seconds.
"""

from __future__ import annotations

import json
import time

__all__ = ["Profiler"]


class Profiler:
    def __init__(self) -> None:
        self.start_ticks: dict[str, float] = {}
        self.data: dict[str, object] = {}
        self.elapsed_ticks: dict[str, tuple[float, int]] = {}

    def set(self, name: str, value) -> None:
        self.data[name] = value

    def start(self, name: str) -> None:
        self.start_ticks[name] = time.time()

    def end(self, name: str) -> float:
        if name not in self.start_ticks:
            return -1.0
        elapsed = time.time() - self.start_ticks.pop(name)
        total, count = self.elapsed_ticks.get(name, (0.0, 0))
        self.elapsed_ticks[name] = (total + elapsed, count + 1)
        self.data[name] = self.elapsed_ticks[name][0] / self.elapsed_ticks[name][1]
        return elapsed

    def dumps(self, indent: int | None = 2) -> str:
        return json.dumps(self.data, indent=indent, default=str)
