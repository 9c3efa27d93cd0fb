"""The traced window: torch.profiler over the cell's cards while the loop
runs, reduced to device intervals on the host's clock, so the loop's
records and the cards' operations lie side by side: each stretch in which
no operation ran on a card is charged to what the host was doing then.

A cell of several cards reads as its average card: busy seconds are the
mean over the cell's cards of each card's busy seconds (a card with no
operation in the window counts as idle throughout), and each card's idle
stretches are charged divided by the card count. With one card every
number is that card's.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    """ops: (name, start, end) of every device operation in the window, on
    the host's clock (seconds), in start order; window: (start, end);
    busy_s: the mean over the cell's cards of each card's busy seconds;
    intervals: the union of every operation's interval; cards: each card's
    union, in the cell's order (None: one card, whose union is
    intervals)."""
    ops: list
    window: tuple
    busy_s: float = 0.0
    intervals: list = field(default_factory=list)
    cards: list = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def card_intervals(self) -> list:
        """Each card's union of operation intervals, in the cell's order."""
        return [self.intervals] if self.cards is None else self.cards

    @property
    def busy_s_by_card(self) -> list:
        """Each card's busy seconds, in the cell's order."""
        return [sum(e - s for s, e in iv) for iv in self.card_intervals]

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

    def idle_gaps(self) -> list:
        """Each card's idle stretches, (start, end) in order; the cards in
        the cell's order."""
        return [gaps(iv, self.window) for iv in self.card_intervals]

    def idle_by_phase(self, phases, top: int = 10) -> list:
        """The average card's idle seconds by what the host was doing:
        phases is a list of (label, start, end) on the host's clock; idle
        time outside every phase is "between requests"."""
        phases = sorted(phases, key=lambda p: p[1])
        starts = [p[1] for p in phases]
        out = defaultdict(float)
        card_gaps = self.idle_gaps()
        n = len(card_gaps)
        for idle in card_gaps:
            for g0, g1 in idle:
                covered = 0.0
                i = max(0, bisect.bisect_right(starts, g0) - 1)
                while i < len(phases) and phases[i][1] < g1:
                    label, s, e = phases[i]
                    ov = min(e, g1) - max(s, g0)
                    if ov > 0:
                        out[label] += ov / n
                        covered += ov
                    i += 1
                out["between requests"] += ((g1 - g0) - covered) / n
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


def gaps(intervals, window) -> list:
    """(start, end) of every stretch of `window` that the ordered, disjoint
    `intervals` leave uncovered, in order."""
    out, t = [], window[0]
    for s, e in intervals:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < window[1]:
        out.append((t, window[1]))
    return out


def reduce_events(events, window, cards) -> Trace:
    """The Trace of `events`, (card, name, start, end) on the host's clock,
    over `window` on the cell's `cards` (their indices, in order): each
    operation clipped to the window, those wholly outside it dropped. An
    operation on a card outside `cards` is listed in ops and intervals and
    counts toward no card's busy time."""
    t0, t1 = window
    ops, per_card = [], {c: [] for c in cards}
    for card, name, s, e in events:
        if e > t0 and s < t1:
            op = (name, max(s, t0), min(e, t1))
            ops.append(op)
            if card in per_card:
                per_card[card].append(op[1:])
    ops.sort(key=lambda o: o[1])
    each = [union(per_card[c]) for c in cards]
    busy = [sum(e - s for s, e in iv) for iv in each]
    return Trace(ops, (t0, t1), sum(busy) / len(busy),
                 union((s, e) for _, s, e in ops), each)


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return name.split("(")[0][:120]


class Tracer:
    """with Tracer(on, devices) as tr: ... ; tr.trace() after the block.
    Off, it does nothing and trace() is None. On, torch.profiler records
    the cards' activity alone (kernels, copies), whose timestamps are on
    the wall clock; the wall clock read beside time.perf_counter at the
    window's start puts them on the host's clock. Every card of `devices`
    (the cell's, in order) is synchronised at both ends of the window."""

    def __init__(self, on: bool, devices=()):
        self.on = on
        self.devices = list(devices)
        self.prof = None

    def _sync(self):
        import torch
        for d in self.devices:
            torch.cuda.synchronize(d)

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._sync()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.offset = self.t0 - time.time_ns() / 1e9
        return self

    def __exit__(self, *exc):
        if self.on:
            self._sync()
            self.t1 = time.perf_counter()
            self.prof.__exit__(*exc)
        return False

    def trace(self):
        """The window's device operations on the host's clock, by card."""
        if not self.on:
            return None
        import torch
        from torch.autograd import DeviceType
        events = [(e.device_index(), short_name(e.name()),
                   e.start_ns() / 1e9 + self.offset,
                   e.end_ns() / 1e9 + self.offset)
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()]
        return reduce_events(events, (self.t0, self.t1),
                             [torch.device(d).index for d in self.devices])
