"""Reductions of the traced window: the device's operations from
torch.profiler (name, start ns, end ns on the wall clock) and the
service thread's host work logged by the harness (label, start, end)."""

from __future__ import annotations

import bisect

__all__ = ["Trace"]

IDLE = "service.waiting"  # the service thread neither dispatching nor fetching


class Trace:
    def __init__(self, events, window: tuple[int, int], host=()) -> None:
        a, b = window
        self.window = window
        self.events = [(n, max(s, a), min(e, b)) for n, s, e in events if e > a and s < b]
        self.host = sorted(host, key=lambda h: h[1])  # one thread's work: the intervals do not overlap
        self._starts = [h[1] for h in self.host]
        self._busy = _union([(s, e) for _, s, e in self.events])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals, not their sum."""
        return sum(e - s for s, e in self._busy) / 1e9

    def kernels(self, names) -> tuple[int, float]:
        """(count, device seconds) of the operations whose name holds one
        of `names`."""
        n, t = 0, 0
        for name, s, e in self.events:
            if any(k in name for k in names):
                n += 1
                t += e - s
        return n, t / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        a, b = self.window
        out, t = [], a
        for s, e in self._busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < b:
            out.append((t, b))
        return out

    def host_label(self, t: int) -> str:
        """What the service thread was doing at time t."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.host[i][2]:
            return self.host[i][0]
        return IDLE

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the service thread's work at their middle."""
        by_name: dict[str, int] = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
                "idle_gaps": [[self.host_label((s + e) // 2), (e - s) / 1e9] for s, e in gaps]}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]
