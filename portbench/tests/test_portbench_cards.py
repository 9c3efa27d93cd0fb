"""A cell's cards through the harness, on the CPU: the traced window
reduced card by card (one card reads exactly as the single union over
every operation that the reduction took before it read cards), a
configuration's prover(dpk, devices) handed the cell's cards and driven
by prove and batch traffic, one card's Prover where the configuration has
no such hook, and the memory peak read on every card."""

import bisect
import json
import os
import random
import shutil
import types
from collections import defaultdict

import pytest

from portbench import loops, run, spantree, spec, trace
from portbench.tests.conftest import REPO

WINDOW = (1.0, 9.0)


# -- the reduction as one union over every operation (one card) ---------------

def one_union(events, window):
    """(ops, intervals, busy seconds): the window's operations clipped to
    it, in start order, and their single union."""
    t0, t1 = window
    ops = [(name, max(s, t0), min(e, t1)) for _, name, s, e in events
           if e > t0 and s < t1]
    ops.sort(key=lambda o: o[1])
    spans = trace.union((s, e) for _, s, e in ops)
    return ops, spans, sum(e - s for s, e in spans)


def one_union_idle_by_phase(intervals, window, phases, top=10):
    idle, t = [], window[0]
    for s, e in intervals:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < window[1]:
        idle.append((t, window[1]))
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


def synthetic_events(seed, cards, n=400):
    """n overlapping operations of a few names on `cards`, some reaching
    over either end of WINDOW or lying wholly outside it."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        s = rng.uniform(WINDOW[0] - 0.5, WINDOW[1] + 0.2)
        out.append((rng.choice(cards), rng.choice("abcde"), s,
                    s + rng.expovariate(60.0)))
    return out


def synthetic_phases(seed):
    rng = random.Random(seed)
    t, out = WINDOW[0], []
    while t < WINDOW[1]:
        d = rng.uniform(0.001, 0.05)
        out.append((rng.choice(["wires", "qap", "msm", "combine"]), t,
                    t + d))
        t += d + rng.choice([0.0, 0.0, 0.01])
    return out


def reader(name):
    return spec.load_module(os.path.join(REPO, "portbench", "metrics",
                                         name + ".py"))


class Span(types.SimpleNamespace):
    pass


def synthetic_spans(seed):
    """Request roots with a child each, on the perf_counter_ns clock."""
    rng = random.Random(seed)
    out, t, i = [], WINDOW[0], 1
    while t < WINDOW[1]:
        d = rng.uniform(0.01, 0.1)
        ns = [int(1e9 * x) for x in (t, t + d / 3, t + d)]
        out.append(Span(name="prover.prove", start=ns[0], end=ns[2], id=i,
                        parent=0, root=i, info=None))
        out.append(Span(name="prover.wires", start=ns[0], end=ns[1],
                        id=i + 1, parent=i, root=i, info=None))
        t, i = t + d + rng.uniform(0.0, 0.02), i + 2
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_card_reads_as_the_single_union(seed):
    events = synthetic_events(seed, [0])
    phases = synthetic_phases(seed)
    ops, spans, busy = one_union(events, WINDOW)
    tr = trace.reduce_events(events, WINDOW, [0])
    assert tr.ops == ops
    assert tr.intervals == spans and tr.card_intervals == [spans]
    assert tr.busy_s == busy and tr.busy_s_by_card == [busy]
    assert tr.window == WINDOW
    assert tr.idle_by_phase(phases) == one_union_idle_by_phase(
        spans, WINDOW, phases)
    # a Trace built from the single union alone reads the same everywhere
    alone = trace.Trace(ops, WINDOW, busy, spans)
    assert alone.idle_by_phase(phases) == tr.idle_by_phase(phases)
    assert alone.by_name() == tr.by_name()
    run_ = types.SimpleNamespace(kind="prove", trace=tr)
    assert reader("device.idle_pct.prove").read(run_) == \
        100.0 * (1.0 - busy / (WINDOW[1] - WINDOW[0]))
    sp = synthetic_spans(seed)
    assert spantree.idle_by_span(tr, sp) == spantree.idle_by_span(alone, sp)
    assert spantree.busy_outside_roots(tr, sp) == \
        spantree.busy_outside_roots(alone, sp)


def test_two_cards_read_per_card_and_as_their_mean():
    window = (0.0, 10.0)
    events = [(0, "a", 0.0, 1.0), (0, "b", 0.5, 2.0), (0, "a", 6.0, 7.0),
              (1, "c", 1.0, 5.0), (1, "c", 12.0, 13.0),
              # a card outside the cell: listed, no card's busy time
              (5, "d", 8.0, 9.0)]
    tr = trace.reduce_events(events, window, [0, 1])
    assert tr.card_intervals == [[[0.0, 2.0], [6.0, 7.0]], [[1.0, 5.0]]]
    assert tr.busy_s_by_card == [3.0, 4.0] and tr.busy_s == 3.5
    assert tr.intervals == [[0.0, 5.0], [6.0, 7.0], [8.0, 9.0]]
    assert [n for n, _, _ in tr.ops] == ["a", "b", "c", "a", "d"]
    run_ = types.SimpleNamespace(kind="batch", trace=tr)
    assert reader("device.idle_pct.batch").read(run_) == \
        pytest.approx(65.0)
    # card 0 idles 2-6 and 7-10, card 1 0-1 and 5-10: wires 3 and 1 s,
    # msm 4 and 5 s, each card's half
    idle = dict(tr.idle_by_phase([("wires", 0.0, 5.0), ("msm", 5.0, 10.0)]))
    assert idle == pytest.approx({"wires": 2.0, "msm": 4.5})
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_a_card_with_no_operation_reads_wholly_idle():
    events = synthetic_events(4, [0, 1])
    tr = trace.reduce_events(events, WINDOW, [0, 1, 2])
    assert len(tr.busy_s_by_card) == 3 and tr.busy_s_by_card[2] == 0.0
    assert tr.idle_gaps()[2] == [WINDOW]
    assert tr.busy_s == pytest.approx(sum(tr.busy_s_by_card) / 3)
    lone = trace.reduce_events([], WINDOW, [3])
    assert lone.busy_s == 0.0 and lone.ops == []
    run_ = types.SimpleNamespace(kind="tx", trace=lone)
    assert reader("device.idle_pct.tx").read(run_) == 100.0
    phases = synthetic_phases(4)
    assert sum(v for _, v in tr.idle_by_phase(phases, top=99)) == \
        pytest.approx(tr.window_s - tr.busy_s)
    sp = synthetic_spans(4)
    assert sum(v for _, v in spantree.idle_by_span(tr, sp)) == \
        pytest.approx(tr.window_s - tr.busy_s)


# -- what serves the traffic --------------------------------------------------

HOOK = '''
import types

made = []


class Served:
    """A stand-in for what serves the cell: records its calls."""

    window, lanes = 12, 64

    def __init__(self, dpk, devices):
        self.dpk, self.devices = dpk, devices
        self.calls, self.timings, self.closed = [], {}, False
        self.msm_inputs = {}

    def _proof(self, w, r, s):
        return types.SimpleNamespace(a=(w, r), b=s, c=len(self.calls))

    def prove(self, primary, aux, r=None, s=None):
        self.calls.append(("prove", primary, r, s))
        self.timings = {"wires": 1e-6, "qap": 1e-6, "msm": 1e-6,
                        "combine": 1e-6}
        return self._proof(primary, r, s)

    def prove_batch(self, witnesses, rs, ss):
        self.calls.append(("prove_batch", [w[0] for w in witnesses], rs, ss))
        self.timings = {"blinds": 1e-6, "dispatch": 1e-6, "drain": 1e-6}
        return [self._proof(w[0], r, s) for w, r, s in zip(witnesses, rs,
                                                           ss)]

    def close(self):
        self.closed = True


def witness(tx, config):
    return [tx], [tx, tx + 1]
'''

REF = '''
def transaction(rng):
    return rng.randrange(1 << 20)


def statement(tx, config):
    return [tx]
'''


@pytest.fixture
def fake_root(tmp_path, monkeypatch):
    """A checkout of two configurations, "hooked" (its .py defines
    prover(dpk, devices)) and "plain" (it does not), with prove and batch
    cells on 1 and 4 cards, and the keys replaced by a stand-in."""
    root = str(tmp_path)
    bench = os.path.join(root, "portbench")
    for d in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(bench, d))
    for name, text in (("hooked.py", HOOK + "\n\ndef prover(dpk, devices):"
                        "\n    made.append(Served(dpk, devices))"
                        "\n    return made[-1]\n"),
                       ("hooked_ref.py", REF), ("plain.py", HOOK),
                       ("plain_ref.py", REF)):
        with open(os.path.join(bench, "configs", name), "w") as f:
            f.write(text)
    for name in ("hooked", "plain"):
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump({"setup_seed": 1}, f)
    for name, mix in (("prove2", {"kind": "prove", "pool": 2}),
                      ("batch3", {"kind": "batch", "batch": 3, "warm": 1})):
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    shutil.copy(os.path.join(REPO, "portbench", "metrics",
                             "device.idle_pct.prove.py"),
                os.path.join(bench, "metrics"))
    workloads = [{"name": f"{c}.{t}", "config": c, "traffic": t,
                  "chips": chips} for c, chips in (("hooked", 4),
                                                   ("plain", 1))
                 for t in ("prove2", "batch3")]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump({"configs": [{"name": c, "file":
                                f"portbench/configs/{c}.json"}
                               for c in ("hooked", "plain")],
                   "workloads": workloads, "end_to_end": [],
                   "per_layer": [{"name": "device.idle_pct.prove",
                                  "unit": "%", "moves": "proof_p90_s",
                                  "workloads": ["hooked.prove2"]}]}, f)
    monkeypatch.setattr(loops, "Keys", lambda ctx: types.SimpleNamespace(
        dpk=("dpk", ctx.setup_seed), vk=None))
    monkeypatch.setattr(loops, "program_key", lambda dpk, vk: {})
    return root


def context(root, workload, devices):
    cell = spec.Cell(root, workload)
    return run.Context(cell, 2**31 + 17, devices, False)


def test_cards_are_the_cells_cuda_devices():
    import torch
    assert run.cards(4) == [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("kind", ["prove2", "batch3"])
def test_hook_gets_the_cells_cards_and_serves_the_traffic(fake_root, kind):
    devices = run.cards(4)
    ctx = context(fake_root, "hooked." + kind, devices)
    assert ctx.devices == devices and ctx.device == devices[0]
    loop = loops.KINDS[ctx.traffic["kind"]](ctx)
    loop.setup()
    served, = ctx.prog.made
    assert served.dpk == ("dpk", 1) and served.devices == devices
    assert loop.prover is served
    warm = len(served.calls)
    rec = loop.request(0)
    call = served.calls[warm]
    if kind == "prove2":
        assert call[0] == "prove" and rec["proof"].a == (call[1], call[2])
        assert [p[0] for p in loop.phases(rec)] == ["wires", "qap", "msm",
                                                    "combine"]
    else:
        assert call[0] == "prove_batch" and len(rec["proofs"]) == 3
        assert call[1] == loop.primaries()
        assert [p[0] for p in loop.phases(rec)] == ["blinds", "dispatch",
                                                    "drain"]
    loop.close()
    assert served.closed


@pytest.mark.parametrize("kind", ["prove2", "batch3"])
def test_without_a_hook_the_loop_builds_one_cards_prover(fake_root,
                                                         monkeypatch, kind):
    from blockmaze_tpu_torch.groth16 import prover as port_prover
    built = []

    def fake_prover(*args, **kwargs):
        built.append((args, kwargs))
        return ctx.prog.Served(*args)
    monkeypatch.setattr(port_prover, "Prover", fake_prover)
    ctx = context(fake_root, "plain." + kind, ["cpu"])
    loop = loops.KINDS[ctx.traffic["kind"]](ctx)
    loop.setup()
    assert built == [((("dpk", 1), "cpu"), {})]
    assert loop.prover.devices == "cpu" and not ctx.prog.made
    loop.request(0)
    assert loop.prover.calls[-1][0] == ("prove" if kind == "prove2"
                                        else "prove_batch")


def test_run_reads_memory_and_busy_on_every_card(fake_root, monkeypatch):
    """run_cell on four cards, the card's calls stood in for: the peak is
    the fullest card's, beside every card's, and busy seconds come per
    card and as their mean."""
    import torch
    peaks = {0: 7 << 20, 1: 9 << 20, 2: 3 << 20, 3: 8 << 20}
    reset = []
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d: reset.append(d))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "stand-in")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(run.judge, "checks", lambda *a: {
        "failed": {"value": 0, "limit": 0}})
    synced = []

    class Stand(trace.Tracer):
        def __enter__(self):
            synced.append(list(self.devices))
            return self

        def __exit__(self, *exc):
            return False

        def trace(self):
            # card 3 idle throughout
            events = [(0, "k", 0.0, 2.0), (1, "k", 1.0, 5.0),
                      (2, "k", 4.0, 10.0)]
            return trace.reduce_events(events, (0.0, 10.0), [0, 1, 2, 3])
    monkeypatch.setattr(run, "Tracer", Stand)
    devices = run.cards(4)
    res = run.run_cell(fake_root, "hooked.prove2", 2**31 + 99, 0.02, True,
                       devices)
    dev = res["device"]
    assert dev["memory_peak_bytes_by_card"] == [7 << 20, 9 << 20, 3 << 20,
                                                8 << 20]
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_card"])
    assert reset == devices and synced == [devices]
    assert dev["busy_s_by_card"] == [2.0, 4.0, 6.0, 0.0]
    assert dev["busy_s"] == 3.0 and dev["window_s"] == 10.0
    assert dev["count"] == 4 and dev["kind"] == "stand-in"
    assert res["metrics"]["device.idle_pct.prove"]["value"] == 70.0
    assert sum(v for _, v in res["breakdown"]["idle_gaps"]) == \
        pytest.approx(7.0)
    assert list(res)[-1] == "checks" and res["correct"]


def test_one_card_run_reports_its_peak_alone(fake_root, monkeypatch):
    from blockmaze_tpu_torch.groth16 import prover as port_prover
    proof = types.SimpleNamespace(a=1, b=2, c=3)
    monkeypatch.setattr(port_prover, "Prover", lambda dpk, device: types.
                        SimpleNamespace(prove=lambda *a, **k: proof,
                                        timings={}, close=lambda: None))
    monkeypatch.setattr(run.judge, "checks", lambda *a: {
        "failed": {"value": 0, "limit": 0}})
    res = run.run_cell(fake_root, "plain.prove2", 2**31 + 5, 0.02, False,
                       ["cpu"])
    assert res["device"]["memory_peak_bytes"] == 0
    assert res["device"]["memory_peak_bytes_by_card"] == [0]
    assert "busy_s" not in res["device"]
