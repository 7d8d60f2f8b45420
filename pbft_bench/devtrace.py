"""The card's activity over a measured window, from torch.profiler.

A `DeviceTrace` records device events (kernels, copies) with CUPTI in
one process; each event's times are on the Unix clock in ns, which
every process on the host shares, so the traces of several processes
join into one timeline of the card. `union` merges intervals, `gaps`
lists the idle ones, `label_gaps` names each idle gap by what the host
was doing in it.

Starting a trace costs seconds (CUPTI's set-up), so a run opens it in
its set-up, before the window, and keeps only what falls inside.
A short profiler window on this card has now and then returned no
device event at all (`chip_smoke._device_events` retries such
windows); a window of seconds cannot be taken again, so a process whose
trace holds no device event reports none, and the reader of the trace
leaves its metric out rather than reading the card as idle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]


def mono_to_unix_ns() -> int:
    """The Unix clock's lead over the monotonic clock, in ns."""
    a = time.monotonic_ns()
    u = time.time_ns()
    b = time.monotonic_ns()
    return u - (a + b) // 2


class DeviceTrace:
    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self, lo_ns: int, hi_ns: int) -> List[Tuple[int, int, str]]:
        """End the trace -> its device events that overlap [lo, hi] (Unix
        ns), clipped to it."""
        torch = self._torch
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            a, b = max(e.start_ns(), lo_ns), min(e.end_ns(), hi_ns)
            if b > a:
                out.append((a, b, e.name()))
        return out


def union(intervals: Sequence[Interval]) -> List[Interval]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(merged: Sequence[Interval]) -> int:
    return sum(b - a for a, b in merged)


def gaps(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def _overlap(gap: Interval, merged: Sequence[Interval]) -> int:
    a, b = gap
    return sum(max(0, min(b, y) - max(a, x)) for x, y in merged)


def label_gaps(idle: Sequence[Interval], host: Dict[str, List[Interval]],
               default: str, top: int = 10) -> List[List]:
    """The `top` longest idle gaps, each named by the host activity (a
    key of `host`, in its order) that covers most of it, or `default`."""
    merged = {k: union(v) for k, v in host.items()}
    out = []
    for gap in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        cover = {k: _overlap(gap, m) for k, m in merged.items()}
        name = max(cover, key=cover.get) if cover else default
        if not cover or cover[name] * 2 < gap[1] - gap[0]:
            name = default
        out.append([name, (gap[1] - gap[0]) / 1e9])
    return out


def device_ops(events: Sequence[Tuple[int, int, str]], top: int = 10) -> List[List]:
    """Device time by operation name, the `top` largest, seconds."""
    by: Dict[str, int] = {}
    for a, b, name in events:
        key = name[:64]
        by[key] = by.get(key, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
