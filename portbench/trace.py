"""The traced window: torch.profiler over the card while the loop runs,
reduced to device intervals on the host's clock, so the loop's records and
the device's operations lie side by side: each stretch in which no
operation ran on the device is charged to what the host was doing then.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

@dataclass
class Trace:
    """ops: (name, start, end) of every device operation in the window, on
    the host's clock (seconds), in start order; window: (start, end)."""
    ops: list
    window: tuple
    busy_s: float = 0.0
    intervals: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def op_seconds(self, match) -> tuple:
        """(summed seconds, count) of the operations whose name
        match(name) accepts."""
        picked = [e - s for n, s, e in self.ops if match(n)]
        return sum(picked), len(picked)

    def by_name(self, top: int = 10) -> list:
        tot = defaultdict(float)
        for n, s, e in self.ops:
            tot[n] += e - s
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda x: -x[1])[:top]

    def idle_by_phase(self, phases, top: int = 10) -> list:
        """Idle device seconds by what the host was doing: phases is a list
        of (label, start, end) on the host's clock; idle time outside every
        phase is "between requests"."""
        idle, t = [], self.window[0]
        for s, e in self.intervals:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            idle.append((t, self.window[1]))
        phases = sorted(phases, key=lambda p: p[1])
        starts = [p[1] for p in phases]
        out = defaultdict(float)
        for g0, g1 in idle:
            covered = 0.0
            i = max(0, bisect.bisect_right(starts, g0) - 1)
            while i < len(phases) and phases[i][1] < g1:
                label, s, e = phases[i]
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    out[label] += ov
                    covered += ov
                i += 1
            out["between requests"] += (g1 - g0) - covered
        return sorted(([k, v] for k, v in out.items() if v > 0),
                      key=lambda x: -x[1])[:top]


def union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:120]


class Tracer:
    """with Tracer(on) as tr: ... ; tr.trace() after the block. Off, it
    does nothing and trace() is None. On, torch.profiler records the
    card's activity alone (kernels, copies), whose timestamps are on the
    wall clock; the wall clock read beside time.perf_counter at the
    window's start puts them on the host's clock."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.offset = self.t0 - time.time_ns() / 1e9
        return self

    def __exit__(self, *exc):
        if self.on:
            import torch
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.__exit__(*exc)
        return False

    def trace(self):
        """The window's device operations on the host's clock."""
        if not self.on:
            return None
        from torch.autograd import DeviceType
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            s = e.start_ns() / 1e9 + self.offset
            end = e.end_ns() / 1e9 + self.offset
            if end > self.t0 and s < self.t1:
                ops.append((short_name(e.name()), max(s, self.t0),
                            min(end, self.t1)))
        ops.sort(key=lambda o: o[1])
        spans = union((s, e) for _, s, e in ops)
        return Trace(ops, (self.t0, self.t1),
                     sum(e - s for s, e in spans), spans)
