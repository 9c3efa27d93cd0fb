"""The program's spans as the benchmark reads them.

A span (blockmaze_tpu_torch/utils/spans.py) has a name, a start and an end
in time.perf_counter_ns(), its id, its parent's id (0 for none) and its
request's root id. The window's spans come to the metric readers as
run.spans (None where the run recorded none), the kernel launches of the
window as run.launches; portbench/spanrun.py sets both. Durations are
inclusive: a span's seconds hold those of the spans nested in it.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

NS = 1e-9
ROOTS = {"prove": ("prover.prove",), "batch": ("prover.prove_batch",),
         "tx": ("zktx.prove", "zktx.verify")}


class Tree:
    """A window's spans with their ancestry."""

    def __init__(self, spans):
        self.spans = spans
        self.by_id = {s.id: s for s in spans}

    def root_name(self, s):
        root = self.by_id.get(s.root)
        return root.name if root is not None else None

    def has_ancestor(self, s, name: str) -> bool:
        p = self.by_id.get(s.parent)
        while p is not None:
            if p.name == name:
                return True
            p = self.by_id.get(p.parent)
        return False

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def seconds(self, names, roots, within=None) -> float:
        """Summed seconds of the spans named in `names` in requests whose
        root is named in `roots`, and, given `within`, with an ancestor of
        that name."""
        return NS * sum(
            s.end - s.start for s in self.spans
            if s.name in names and self.root_name(s) in roots
            and (within is None or self.has_ancestor(s, within)))


def tree_of(run, kind: str):
    """The run's spans as a Tree, or None where the run recorded none or
    its traffic is not of `kind`."""
    spans = getattr(run, "spans", None)
    if not spans or run.kind != kind:
        return None
    return Tree(spans)


def per_request(run, kind: str, names, within=None, scale=1e3):
    """scale x the seconds of the spans named in `names` (inside `within`,
    if given) over the window's requests of `kind`: proofs (prove,
    batch) or transactions (tx); None where there is nothing to read."""
    tree = tree_of(run, kind)
    if tree is None:
        return None
    if kind == "batch":
        n = sum(len(rec["proofs"]) for rec in run.records)
    else:
        n = tree.count(ROOTS[kind][0])
    if not n:
        return None
    return scale * tree.seconds(names, ROOTS[kind], within) / n


def innermost(spans) -> list:
    """(start, end, name) pieces, in order and in seconds, of the time the
    spans cover, each named after the innermost span open then: the one
    started last (spans of one thread nest)."""
    events = sorted([(s.start, 1, i) for i, s in enumerate(spans)]
                    + [(s.end, 0, i) for i, s in enumerate(spans)])
    heap, closed, out, t = [], set(), [], None
    for now, opens, i in events:
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        if heap and now > t:
            out.append((NS * t, NS * now, spans[heap[0][2]].name))
        if opens:
            heapq.heappush(heap, (-spans[i].start, -spans[i].id, i))
        else:
            closed.add(i)
        t = now
    return out


def idle_by_span(trace, spans) -> list:
    """The average card's idle seconds by the innermost program span open
    then, and "between requests" outside every span: [name, seconds], most
    first. Each card's idle stretches count divided by the card count, so
    the parts sum to the window's idle seconds, window_s - busy_s."""
    pieces = innermost(spans)
    out = defaultdict(float)
    card_gaps = trace.idle_gaps()
    n = len(card_gaps)
    for idle in card_gaps:
        j = 0
        for g0, g1 in idle:
            covered = 0.0
            while j < len(pieces) and pieces[j][1] <= g0:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < g1:
                s, e, name = pieces[k]
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    out[name] += ov / n
                    covered += ov
                k += 1
            out["between requests"] += ((g1 - g0) - covered) / n
    return sorted(([k, v] for k, v in out.items() if v > 0),
                  key=lambda x: -x[1])


def busy_outside_roots(trace, spans) -> float:
    """The average card's busy seconds outside every request root (a span
    without a parent, host.gc apart): near 0 when spans and device
    operations share one clock and every launch comes from a request."""
    roots = sorted((NS * s.start, NS * s.end) for s in spans
                   if s.parent == 0 and s.name != "host.gc")
    cards = trace.card_intervals
    inside = 0.0
    for intervals in cards:
        j = 0
        for b0, b1 in intervals:
            while j < len(roots) and roots[j][1] <= b0:
                j += 1
            k = j
            while k < len(roots) and roots[k][0] < b1:
                inside += max(0.0, min(b1, roots[k][1])
                              - max(b0, roots[k][0]))
                k += 1
    return trace.busy_s - inside / len(cards)


def span_seconds(spans) -> dict:
    """name: [count, inclusive seconds, self seconds (less its children's
    inclusive seconds)], most inclusive time first."""
    total, child, count = defaultdict(int), defaultdict(int), defaultdict(int)
    by_id = {s.id: s for s in spans}
    for s in spans:
        count[s.name] += 1
        total[s.name] += s.end - s.start
        parent = by_id.get(s.parent)
        if parent is not None:
            child[parent.name] += s.end - s.start
    return {n: [count[n], NS * total[n], NS * (total[n] - child[n])]
            for n in sorted(total, key=lambda n: -total[n])}


def gc_by_generation(spans) -> dict:
    """The host.gc spans by the generation collected: {generation: [count,
    seconds]}."""
    out = {}
    for s in spans:
        if s.name == "host.gc":
            c = out.setdefault(s.info["generation"], [0, 0.0])
            c[0] += 1
            c[1] += NS * (s.end - s.start)
    return dict(sorted(out.items()))
