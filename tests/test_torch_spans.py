"""The port's span recorder (blockmaze_tpu_torch/utils/spans.py), the spans
the Prover and ZkTx open, and the benchmark's readers of them
(portbench/spantree.py, the readers of portbench/span_metrics.json,
portbench/spanrun.py's window), all on the CPU.

The Prover's span tree is taken on the toy circuit with the MSMs' device
half (msm_stream) stubbed to the point at infinity: the tree, not the
proof, is under test here (tests/test_torch_prover.py and
tests/test_torch_batch.py hold the proofs)."""

import gc
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import generator, keys
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.ntt import pntt
from blockmaze_tpu_torch.utils import spans
from blockmaze_tpu_torch.zktx import api
from portbench import run as prun
from portbench import spanrun, spantree, spec
from portbench.trace import Trace, union

from test_torch_host_copies import toy_circuit
from test_torch_zktx import Recorder, circuit_args

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Span = spans.Span
MS = 1_000_000          # ns


@pytest.fixture
def recorder():
    """The recorder on, emptied first; off and emptied after."""
    spans.disable()
    spans.drain()
    spans.enable()
    yield
    spans.disable()
    spans.drain()


def by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def inside(child, parent):
    return parent.start <= child.start <= child.end <= parent.end


# -- the recorder -----------------------------------------------------------

def test_off_records_nothing_and_shares_one_noop():
    spans.disable()
    spans.drain()
    a, b = spans.span("a"), spans.span("b")
    assert a is b is spans.NOOP
    with spans.span("a"):
        with spans.span("b"):
            gc.collect()
    with spans.Timed("t") as lap:
        pass
    assert lap.seconds > 0
    assert spans.drain() == []
    assert spans._on_gc not in gc.callbacks


def test_spans_nest_with_parent_and_request_ids(recorder):
    with spans.span("req"):
        with spans.span("a"):
            with spans.span("b"):
                pass
        with spans.span("c"):
            pass
    with spans.span("req"):
        pass
    spans.disable()
    got = by_name(s for s in spans.drain() if s.name != "host.gc")
    (req1, req2), (a,), (b,), (c,) = got["req"], got["a"], got["b"], got["c"]
    assert (req1.parent, req1.root) == (0, req1.id)
    assert (req2.parent, req2.root) == (0, req2.id)
    assert req1.id != req2.id
    assert (a.parent, a.root) == (req1.id, req1.id)
    assert (b.parent, b.root) == (a.id, req1.id)
    assert (c.parent, c.root) == (req1.id, req1.id)
    assert inside(b, a) and inside(a, req1) and inside(c, req1)
    assert a.end <= c.start and req1.end <= req2.start
    assert spans.drain() == []


def test_gc_is_a_span_under_the_open_span(recorder):
    with spans.span("outer"):
        with spans.span("inner"):
            gc.collect()
    spans.disable()
    got = by_name(spans.drain())
    (inner,), (outer,) = got["inner"], got["outer"]
    full = [s for s in got["host.gc"] if s.info == {"generation": 2}]
    assert full, got["host.gc"]
    assert all(s.parent == inner.id and s.root == outer.id
               and inside(s, inner) for s in full)


def test_timed_syncs_inside_its_span_unless_the_block_raises(recorder):
    calls = []

    def sync():
        with spans.span("device.wait"):
            calls.append(1)

    with spans.Timed("lap", sync=sync) as lap:
        pass
    with pytest.raises(KeyError):
        with spans.Timed("lap", sync=sync):
            raise KeyError
    spans.disable()
    got = by_name(s for s in spans.drain() if s.name != "host.gc")
    assert calls == [1]
    ok, failed = got["lap"]
    (wait,) = got["device.wait"]
    assert wait.parent == ok.id and inside(wait, ok)
    assert lap.seconds == (ok.end - ok.start) / 1e9
    assert failed.root == failed.id


def test_carry_nests_other_threads_under_the_callers_spans(recorder):
    """spans.carry: calls on more threads than cores, the interpreter
    switching threads often, record under the span open where the function
    was carried and in its request; no id is given twice, and each thread's
    stack holds the carried ids during its call alone."""
    def work(_):
        with spans.span("inner"):
            with spans.span("leaf"):
                pass
        return list(spans._stack())

    def call(k):
        return carried(k), list(spans._stack())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.span("req"):
            with spans.span("batch"):
                carried = spans.carry(work)
                with ThreadPoolExecutor((os.cpu_count() or 1) + 1) as pool:
                    stacks = list(pool.map(call, range(400), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    spans.disable()
    recorded = [s for s in spans.drain() if s.name != "host.gc"]
    got = by_name(recorded)
    (req,), (batch,) = got["req"], got["batch"]
    assert stacks == [([req.id, batch.id], [])] * 400
    assert spans._stack() == []
    assert len({s.id for s in recorded}) == len(recorded) == 802
    assert all(s.parent == batch.id and s.root == req.id and inside(s, batch)
               for s in got["inner"])
    inner = {s.id: s for s in got["inner"]}
    assert sorted(s.parent for s in got["leaf"]) == sorted(inner)
    assert all(s.root == req.id and inside(s, inner[s.parent])
               for s in got["leaf"])


# -- the Prover's spans ----------------------------------------------------

PROVE_TREE = {
    "prover.wires": ("prover.prove", 1), "prover.qap": ("prover.prove", 1),
    "prover.msm": ("prover.prove", 1), "prover.combine": ("prover.prove", 1),
    "prover.limbs": ("prover.wires", 1), "prover.upload": ("prover.wires", 1),
    "prover.blinds": ("prover.wires", 1),
    "prover.fetch": ("prover.combine", 1),
    "prover.unblind": ("prover.combine", 1),
    "prover.group": ("prover.combine", 1),
    "msm.query": ("prover.msm", 5), "msm.stream": ("msm.query", 5)}
BATCH_TREE = {
    "prover.blinds": ("prover.prove_batch", 1),
    "prover.dispatch": ("prover.prove_batch", 1),
    "prover.drain": ("prover.prove_batch", 1),
    "prover.limbs": ("prover.dispatch", 2),
    "prover.upload": ("prover.dispatch", 2),
    "prover.fetch": ("prover.dispatch", 2),
    "prover.submit": ("prover.dispatch", 2),
    "prover.unblind": ("prover.prove_batch", 2),
    "prover.group": ("prover.prove_batch", 2),
    "msm.query": ("prover.dispatch", 10)}


def infinity_msm(curve, points, stream, c, lanes, blind=None, step=None):
    X, Y, Z = (t[0] for t in pp._zeros_pts(curve, 1, points[0].device))
    return X, Y, Z, torch.zeros(pp.n_windows(c), dtype=torch.int64)


@pytest.fixture(scope="module")
def prover_runs():
    """(prove's spans and timings, prove_batch's, and both timings with
    the recorder off) on the toy circuit, MSMs stubbed."""
    w = 5551212
    pb = toy_circuit(w * w % R_MOD, w)
    toxic = iter([3, 5, 7, 11, 13])
    pk, _ = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    inst = (pb.primary_input(), pb.auxiliary_input())
    mp = pytest.MonkeyPatch()
    mp.setattr(pp, "msm_stream", infinity_msm)
    prover = Prover(keys.build_device_pk(pk), "cpu", lanes=8, window=4)
    out = {}
    try:
        spans.drain()
        spans.enable()
        prover.prove(*inst, r=7, s=9)
        out["prove"] = spans.drain(), dict(prover.timings)
        prover.prove_batch([inst, inst], rs=[7, 3], ss=[9, 5])
        out["batch"] = spans.drain(), dict(prover.timings)
        spans.disable()
        prover.prove(*inst, r=7, s=9)
        out["prove off"] = dict(prover.timings)
        prover.prove_batch([inst], rs=[7], ss=[9])
        out["batch off"] = dict(prover.timings)
        out["off spans"] = spans.drain()
    finally:
        spans.disable()
        prover.close()
        mp.undo()
    return out


def check_tree(recorded, root_name, tree):
    recorded = [s for s in recorded if s.name != "host.gc"]
    ids = {s.id: s for s in recorded}
    (root,) = [s for s in recorded if s.parent == 0]
    assert root.name == root_name and root.root == root.id
    for s in recorded:
        assert s.root == root.id, s
        if s.parent:
            assert inside(s, ids[s.parent]), s
    names = by_name(recorded)
    for name, (parent, n) in tree.items():
        got = [s for s in names[name] if ids.get(s.parent, root).name
               == parent]
        assert len(got) == n, (name, names[name])
    return names, ids


def test_prove_span_tree(prover_runs):
    recorded, timings = prover_runs["prove"]
    names, ids = check_tree(recorded, "prover.prove", PROVE_TREE)
    waits = names["device.wait"]
    # one live count per MSM in its msm.stream, one closing sync a lap
    under_msm = [s for s in waits if ids[s.parent].name == "prover.msm"]
    in_stream = [s for s in waits if ids[s.parent].name == "msm.stream"]
    assert len(under_msm) == 1 and len(in_stream) == 5
    for lap in ("wires", "qap", "msm", "combine"):
        (span,) = names["prover." + lap]
        assert timings[lap] == (span.end - span.start) / 1e9
        assert any(w.parent == span.id for w in waits), lap
    assert list(timings) == ["wires", "qap", "msm", "combine"]


def test_prove_batch_span_tree(prover_runs):
    recorded, timings = prover_runs["batch"]
    names, ids = check_tree(recorded, "prover.prove_batch", BATCH_TREE)
    for lap in ("blinds", "dispatch", "drain"):
        (span,) = [s for s in names["prover." + lap]
                   if ids[s.parent].name == "prover.prove_batch"]
        assert timings[lap] == (span.end - span.start) / 1e9
    assert timings["limbs"] == pytest.approx(sum(
        (s.end - s.start) / 1e9 for s in names["prover.limbs"]))
    # the combines run on the combine thread, under the batch's root
    for name, muls in (("prover.unblind", 5), ("prover.group", 6)):
        assert [s.info for s in names[name]] == [{"muls": muls}] * 2


def test_timings_keep_their_keys_with_the_recorder_off(prover_runs):
    assert list(prover_runs["prove off"]) == list(prover_runs["prove"][1])
    assert list(prover_runs["batch off"]) == list(prover_runs["batch"][1])
    assert prover_runs["off spans"] == []


def test_limbs_span_counts_wide_wires_and_proofs_keep_their_limbs(
        monkeypatch, recorder):
    """prover.limbs' info counts the wires and those at or above 2^64; two
    proofs on one Prover (its limb buffer reused) upload each witness's
    own limbs, still intact after the second."""
    big = 2**100 + 7
    pbs = [toy_circuit(w * w % R_MOD, w) for w in (big, 5)]
    toxic = iter([3, 5, 7, 11, 13])
    pk, _ = generator.generate(pbs[0], "cpu", rng=lambda: next(toxic))
    monkeypatch.setattr(pp, "msm_stream", infinity_msm)
    dpk = keys.build_device_pk(pk)
    prover = Prover(dpk, "cpu", lanes=8, window=4)
    uploaded = []

    def upload(limbs, _upload=prover._upload):
        uploaded.append(_upload(limbs))
        return uploaded[-1]

    monkeypatch.setattr(prover, "_upload", upload)
    for pb in pbs:
        prover.prove(pb.primary_input(), pb.auxiliary_input(), r=7, s=9)
    spans.disable()
    infos = [s.info for s in spans.drain() if s.name == "prover.limbs"]
    wires = [[1] + pb.primary_input() + pb.auxiliary_input() for pb in pbs]
    assert infos == [{"wires": dpk.num_variables + 1,
                      "wide": sum(x >= 2**64 for x in w)} for w in wires]
    assert infos[0]["wide"] > 0 == infos[1]["wide"]
    for (std, _), w in zip(uploaded, wires):
        assert np.array_equal(std.numpy().view(np.uint32),
                              tf.ints_to_limbs(w))


def test_upload_span_counts_the_words_and_wide_rows_it_copies(monkeypatch,
                                                             recorder):
    """prover.upload's info: 8 bytes a wire and 68 a wide row (its row and
    16 limbs), not pinned on the CPU, the wide rows prover.limbs counted;
    its Montgomery form equals the route through ints_to_limbs."""
    pbs = [toy_circuit(w * w % R_MOD, w) for w in (2**100 + 7, 5)]
    toxic = iter([3, 5, 7, 11, 13])
    pk, _ = generator.generate(pbs[0], "cpu", rng=lambda: next(toxic))
    monkeypatch.setattr(pp, "msm_stream", infinity_msm)
    dpk = keys.build_device_pk(pk)
    prover = Prover(dpk, "cpu", lanes=8, window=4)
    uploaded = []

    def upload(wide, _upload=prover._upload):
        uploaded.append(_upload(wide))
        return uploaded[-1]

    monkeypatch.setattr(prover, "_upload", upload)
    for pb in pbs:
        prover.prove(pb.primary_input(), pb.auxiliary_input(), r=7, s=9)
    spans.disable()
    recorded = spans.drain()
    limbs = [s.info for s in recorded if s.name == "prover.limbs"]
    uploads = [s.info for s in recorded if s.name == "prover.upload"]
    n = dpk.num_variables + 1
    assert uploads == [{"bytes": 8 * n + 68 * i["wide"], "pinned": 0,
                        "wide": i["wide"]} for i in limbs]
    assert uploads[0]["wide"] > 0 == uploads[1]["wide"]
    for (_, mont), pb in zip(uploaded, pbs):
        std = tf.to_tensor(tf.ints_to_limbs(
            [1] + pb.primary_input() + pb.auxiliary_input()), "cpu")
        assert torch.equal(mont, pntt.mul_elementwise(std, prover._r2))


def test_msm_query_spans_hold_the_stream_and_its_lane_cut(monkeypatch,
                                                         recorder):
    """msm.query: one a MSM, five a prove, each under prover.msm with its
    msm.stream (the live count's wait inside it), and its info the live
    items peaks.msm_round_counts counts on the same inputs and the lanes
    lane_cut cuts them into; with the recorder off, nothing is recorded."""
    from portbench import peaks
    w = 5551212
    pb = toy_circuit(w * w % R_MOD, w)
    toxic = iter([3, 5, 7, 11, 13])
    pk, _ = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    monkeypatch.setattr(pp, "msm_stream", infinity_msm)
    prover = Prover(keys.build_device_pk(pk), "cpu", lanes=8, window=4)
    inst = (pb.primary_input(), pb.auxiliary_input())
    prover.prove(*inst, r=7, s=9)
    spans.disable()
    names, ids = check_tree(spans.drain(), "prover.prove", PROVE_TREE)
    queries = names["msm.query"]
    assert len(queries) == len(prover.msm_inputs) == 5
    lives = []
    for q, (name, (pts, scalars)) in zip(queries, prover.msm_inputs.items()):
        curve = "g2" if name == "B g2" else "g1"
        live, _ = peaks.msm_round_counts(curve, pts[2], scalars, 4, 8,
                                         pp.MIN_ITEMS)
        T, L = pp.lane_cut(live, 8) if live else (0, 0)
        assert q.info == {"curve": curve, "points": pts[0].shape[0], "c": 4,
                          "windows": pp.n_windows(4), "live": live,
                          "lanes": T, "per_lane": L}, name
        lives.append(live)
    assert sum(lives) > 0
    for st in names["msm.stream"]:
        (wait,) = [s for s in names["device.wait"] if s.parent == st.id]
        assert inside(wait, st)
    prover.prove(*inst, r=7, s=9)
    assert spans.drain() == []


# -- ZkTx's spans -----------------------------------------------------------

@pytest.mark.parametrize("name", ["mint", "send", "deposit", "redeem"])
def test_zktx_span_tree(name, tmp_path, monkeypatch, recorder):
    gen_args, ver_args = circuit_args(name)
    svc = api.ZkTx(str(tmp_path), 8, device="cpu")
    ctx = svc.circuits[name]
    ctx._prover, ctx._vk = Recorder(), "vk"
    monkeypatch.setattr(api, "gver", Recorder())
    assert gc.isenabled()
    proof_hex, primary = getattr(svc, f"gen_{name}_proof")(*gen_args)
    assert getattr(svc, f"verify_{name}_proof")(proof_hex, *ver_args)
    spans.disable()
    recorded = [s for s in spans.drain() if s.name != "host.gc"]
    names = by_name(recorded)
    (prove,), (verify,) = names["zktx.prove"], names["zktx.verify"]
    assert prove.parent == verify.parent == 0 and prove.end <= verify.start
    for stage in ("zktx.notes", "zktx.witness", "zktx.encode"):
        (s,) = names[stage]
        assert s.parent == prove.id and inside(s, prove)
    assert names["zktx.notes"][0].end <= names["zktx.witness"][0].start
    assert names["zktx.witness"][0].end <= names["zktx.encode"][0].start
    assert names["zktx.witness"][0].info == {"gc_held": 1}
    assert all(names[s][0].info is None
               for s in ("zktx.prove", "zktx.notes", "zktx.encode"))
    assert len(recorded) == 5
    assert ctx._prover.calls[0][0] == primary


# -- the benchmark's readers -------------------------------------------------

class FakeRun:
    def __init__(self, kind, recorded, records=(), launches=None):
        self.kind, self.spans, self.records = kind, recorded, list(records)
        self.launches = launches


class SpanMaker:
    """Spans with ids, parents and roots as the recorder sets them."""

    def __init__(self):
        self.out, self.next = [], 1

    def add(self, name, start, end, parent=None, info=None):
        sid, self.next = self.next, self.next + 1
        root = parent.root if parent is not None else sid
        s = Span(name, start * MS, end * MS, sid,
                 parent.id if parent is not None else 0, root, info)
        self.out.append(s)
        return s


def prove_window(msm_spans=True):
    """Two proofs, 100 ms each: laps wires 0-40 (limbs 0-20 with a 5-ms
    collection, upload 20-30, blinds 30-40), qap 40-45, msm 45-70 (two
    MSMs, msm.query 46-58 and 59-69, each with its msm.stream, 47-53 and
    59-64, around a wait, 50-52 and 60-63; without msm_spans, as a program
    without them records, the waits alone), combine 70-100 (fetch 70-72,
    unblind 72-90, group 90-99). The MSMs' live items: 3.0M and 1.5M, then
    2.0M and 1.0M; their lanes' items: 320 and 65, then 176 and 65."""
    b = SpanMaker()
    queries = [((3_000_000, 320), (1_500_000, 65)),
               ((2_000_000, 176), (1_000_000, 65))]
    for k in range(2):
        t = 100 * k
        root = b.add("prover.prove", t, t + 100)
        wires = b.add("prover.wires", t, t + 40, root)
        limbs = b.add("prover.limbs", t, t + 20, wires)
        b.add("host.gc", t + 10, t + 15, limbs, {"generation": 0})
        b.add("prover.upload", t + 20, t + 30, wires)
        b.add("prover.blinds", t + 30, t + 40, wires)
        b.add("prover.qap", t + 40, t + 45, root)
        msm = b.add("prover.msm", t + 45, t + 70, root)
        for (q0, q1, s0, s1, w0, w1), (live, per_lane) in zip(
                ((46, 58, 47, 53, 50, 52), (59, 69, 59, 64, 60, 63)),
                queries[k]):
            parent = msm
            if msm_spans:
                query = b.add("msm.query", t + q0, t + q1, msm,
                              {"curve": "g1", "points": 1 << 20, "c": 13,
                               "windows": 20, "live": live,
                               "lanes": -(-live // per_lane),
                               "per_lane": per_lane})
                parent = b.add("msm.stream", t + s0, t + s1, query)
            b.add("device.wait", t + w0, t + w1, parent)
        combine = b.add("prover.combine", t + 70, t + 100, root)
        b.add("prover.fetch", t + 70, t + 72, combine)
        b.add("prover.unblind", t + 72, t + 90, combine)
        b.add("prover.group", t + 90, t + 99, combine)
    return b.out


def batch_window():
    """One batch of two proofs: dispatch 10-90 with per proof limbs (8 ms),
    a wait (3 ms) and a fetch (4 ms), and a closing wait of 1 ms."""
    b = SpanMaker()
    root = b.add("prover.prove_batch", 0, 100)
    b.add("prover.blinds", 0, 10, root)
    dispatch = b.add("prover.dispatch", 10, 90, root)
    for t in (10, 50):
        b.add("prover.limbs", t, t + 8, dispatch)
        b.add("device.wait", t + 20, t + 23, dispatch)
        b.add("prover.fetch", t + 30, t + 34, dispatch)
    b.add("device.wait", 89, 90, dispatch)
    b.add("prover.drain", 90, 100, root)
    b.add("prover.limbs", 200, 230)     # outside the batch: not read
    return b.out


def tx_window():
    """Two transactions of 1 s: notes 0-100 ms, witness 100-700 (a 40-ms
    collection), the proof 700-900, encode 900-910; verify 1000-1100 with
    a 10-ms collection."""
    b = SpanMaker()
    for k in range(2):
        t = 2000 * k
        root = b.add("zktx.prove", t, t + 1000)
        b.add("zktx.notes", t, t + 100, root)
        wit = b.add("zktx.witness", t + 100, t + 700, root)
        b.add("host.gc", t + 300, t + 340, wit, {"generation": 1})
        b.add("prover.prove", t + 700, t + 900, root)
        b.add("zktx.encode", t + 900, t + 910, root)
        ver = b.add("zktx.verify", t + 1000, t + 1100)
        b.add("host.gc", t + 1050, t + 1060, ver, {"generation": 0})
    b.add("host.gc", 5000, 5100, None, {"generation": 2})  # no request
    return b.out


READINGS = [
    ("prover.limbs_ms", "prove", 20.0), ("prover.upload_ms", "prove", 10.0),
    ("prover.blinds_ms", "prove", 10.0), ("prover.fetch_ms", "prove", 2.0),
    ("prover.unblind_ms", "prove", 18.0), ("prover.group_ms", "prove", 9.0),
    ("msm.wait_ms", "prove", 5.0), ("kernel.launches_per_proof", "prove",
                                    15.5),
    ("host.gc_ms.prove", "prove", 5.0), ("batch.limbs_ms", "batch", 8.0),
    ("batch.wait_ms", "batch", 7.5), ("zktx.witness_s", "tx", 0.6),
    ("host.gc_ms.tx", "tx", 50.0)]
# Readers of the msm.query and msm.stream spans, not yet listed in
# span_metrics.json
MSM_READINGS = [("msm.stream_ms", "prove", 11.0),
                ("msm.live_mitems", "prove", 3.75),
                ("msm.lane_items_max", "prove", 248.0)]
WINDOWS = {"prove": (prove_window, [{}] * 2),
           "batch": (batch_window, [{"proofs": [1, 2]}]),
           "tx": (tx_window, [{}] * 2)}


def reader(name):
    return spec.load_module(os.path.join(ROOT, "portbench", "metrics",
                                         name + ".py"))


@pytest.mark.parametrize("name,kind,want", READINGS + MSM_READINGS)
def test_span_metric_readers(name, kind, want):
    window, records = WINDOWS[kind]
    read = reader(name).read
    got = read(FakeRun(kind, window(), records, {"fft": 20, "msm_round": 11}))
    assert got == pytest.approx(want)
    other = "tx" if kind != "tx" else "prove"
    assert read(FakeRun(other, WINDOWS[other][0](), WINDOWS[other][1])) \
        is None
    assert read(FakeRun(kind, None, records)) is None     # untraced run


@pytest.mark.parametrize("name", [n for n, _, _ in MSM_READINGS])
def test_msm_readers_read_nothing_without_msm_spans(name):
    """A program that records no msm.query or msm.stream (one older than
    these spans) reads as nothing, not as 0, and raises nothing."""
    run = FakeRun("prove", prove_window(msm_spans=False), [{}] * 2)
    assert reader(name).read(run) is None
    assert reader("msm.wait_ms").read(run) == pytest.approx(5.0)


def test_span_metrics_file_matches_its_readers():
    bench = spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"] for w in bench["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells))
                for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]} | {"host"}
    with open(spanrun.SPAN_METRICS) as f:
        entries = json.load(f)
    assert sorted(e["name"] for e in entries) == sorted(n for n, _, _ in
                                                        READINGS)
    for e in entries:
        assert set(e) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert e["source"] == "program_span" and e["layer"] in layers
        assert set(e["workloads"]) <= reported[e["moves"]]
        assert callable(reader(e["name"]).read)


# -- idle device time by span --------------------------------------------------

def trace_of(busy, window):
    iv = union(busy)
    return Trace([("k", s, e) for s, e in busy], window,
                 sum(e - s for s, e in iv), iv)


def test_idle_goes_to_the_innermost_span():
    b = SpanMaker()
    root = b.add("prover.prove", 100, 900)
    wires = b.add("prover.wires", 100, 400, root)
    limbs = b.add("prover.limbs", 100, 300, wires)
    b.add("host.gc", 150, 170, limbs, {"generation": 0})
    msm = b.add("prover.msm", 400, 700, root)
    b.add("device.wait", 450, 650, msm)
    # busy 300-350 (in wires) and 460-640 (under the wait), in seconds
    tr = trace_of([(0.30, 0.35), (0.46, 0.64)], (0.0, 1.0))
    got = dict(spantree.idle_by_span(tr, b.out))
    want = {"between requests": 0.1 + 0.1, "prover.limbs": 0.18,
            "host.gc": 0.02, "prover.wires": 0.05, "prover.msm": 0.1,
            "device.wait": 0.02, "prover.prove": 0.2}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    idle = tr.window_s - tr.busy_s
    assert sum(got.values()) == pytest.approx(idle)
    assert spantree.busy_outside_roots(tr, b.out) == pytest.approx(0.0)
    late = trace_of([(0.30, 0.35), (0.85, 0.95)], (0.0, 1.0))
    assert spantree.busy_outside_roots(late, b.out) == pytest.approx(0.05)


def test_span_seconds_counts_inclusive_and_self_time():
    got = spantree.span_seconds(prove_window())
    assert got["prover.prove"] == pytest.approx([2, 0.2, 0.0])
    assert got["prover.msm"] == pytest.approx([2, 0.05, 0.006])
    assert got["msm.query"] == pytest.approx([4, 0.044, 0.022])
    assert got["prover.limbs"] == pytest.approx([2, 0.04, 0.03])
    assert list(got)[0] == "prover.prove"
    assert spantree.gc_by_generation(tx_window()) == {
        0: [2, pytest.approx(0.02)], 1: [2, pytest.approx(0.08)],
        2: [1, pytest.approx(0.1)]}


def test_spanrun_records_the_window_and_restores_run():
    """spanrun's window: the recorder on over run.window alone, its spans
    and launch counts handed over, run's window and Tracer put back."""

    class Loop:
        kind = "prove"

        def request(self, n):
            with spans.span("prover.prove"):
                return {"n": n}

    spans.disable()
    window, tracer = prun.window, prun.Tracer
    seen = {}
    with spanrun.recording(seen):
        with spans.span("outside"):
            pass
        records, failed, _, _ = prun.window(Loop(), 0.01, False)
    assert (prun.window, prun.Tracer) == (window, tracer)
    assert not spans._on and failed == 0 and records
    got = [s for s in seen["spans"] if s.name != "host.gc"]
    assert [s.name for s in got] == ["prover.prove"] * len(records)
    assert seen["launches"] == {} and seen["loop"].kind == "prove"
