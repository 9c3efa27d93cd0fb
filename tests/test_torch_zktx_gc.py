"""ZkTx's hold of the cyclic garbage collector (zktx/api.py hold_gc) around
each circuit's synthesis: the synthesis leaves no cycle for the collector,
the prover is handed the same (primary, aux) with the hold as with the
collector on, the hold restores the collector's state across nesting and
threads, and no collection runs under zktx.notes or zktx.witness.

The recording stub of tests/test_torch_zktx.py stands in for each
circuit's prover and for the verifier, so no proof is computed here."""

import collections
import contextlib
import gc
import os
import sys
import threading

import pytest
import torch

from blockmaze_tpu_torch.utils import spans
from blockmaze_tpu_torch.zktx import api

from test_torch_spans import by_name, recorder  # noqa: F401 (a fixture)
from test_torch_zktx import Recorder, circuit_args

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

CIRCUITS = ["mint", "send", "deposit", "redeem"]


@pytest.fixture(autouse=True)
def collector_on():
    """Each test starts with the collector on and leaves it on."""
    assert gc.isenabled()
    yield
    gc.enable()


class Counting(Recorder):
    """The prover's recording stub, which also keeps the number of objects
    the collector tracks when each proof is asked for."""

    def __init__(self):
        super().__init__()
        self.tracked = []

    def prove(self, primary, aux_input):
        self.tracked.append(len(gc.get_objects()))
        return super().prove(primary, aux_input)


def service(name, tmp_path, monkeypatch):
    """A depth-8 service whose `name` prover and verifier are recording
    stubs, and the prover's stub."""
    svc = api.ZkTx(str(tmp_path), 8, device="cpu")
    ctx = svc.circuits[name]
    ctx._prover, ctx._vk = Counting(), "vk"
    monkeypatch.setattr(api, "gver", Recorder())
    return svc, ctx._prover


def unheld(monkeypatch):
    """hold_gc replaced by a block that leaves the collector as it is."""
    monkeypatch.setattr(api, "hold_gc", lambda: contextlib.nullcontext(0))


@contextlib.contextmanager
def collections_by_generation():
    """The collections that run in the block, counted by generation."""
    counts = collections.Counter()

    def hook(phase, info):
        if phase == "stop":
            counts[info["generation"]] += 1
    gc.callbacks.append(hook)
    try:
        yield counts
    finally:
        gc.callbacks.remove(hook)


def unreachable():
    """gc.collect()'s count of unreachable objects, and their types."""
    flags = gc.get_debug()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        found = gc.collect()
        kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
    return found, kinds.most_common(10)


@pytest.mark.parametrize("name", CIRCUITS)
def test_synthesis_restores_the_collector_and_leaves_no_cycle(
        name, tmp_path, monkeypatch):
    svc, prover = service(name, tmp_path, monkeypatch)
    gen_args, _ = circuit_args(name)
    gen = getattr(svc, f"gen_{name}_proof")
    gen(*gen_args)      # the first call's imports and caches
    assert gc.isenabled()
    gc.collect()
    tracked = len(gc.get_objects())
    gen(*gen_args)
    assert gc.isenabled()
    # what the synthesis made died under the hold: a collection while the
    # prover runs finds the notes and the inputs, not the protoboard
    assert prover.tracked[-1] - tracked < 100
    gc.collect()
    with api.hold_gc() as held:
        assert held == 1 and not gc.isenabled()
        gen(*gen_args)
        assert not gc.isenabled()
        assert unreachable() == (0, [])
    assert gc.isenabled()
    assert prover.calls[0] == prover.calls[1] == prover.calls[2]


@pytest.mark.parametrize("name", CIRCUITS)
def test_hold_hands_the_prover_the_same_witness(name, tmp_path, monkeypatch):
    gen_args, ver_args = circuit_args(name)
    out = []
    for hold in (True, False):
        with monkeypatch.context() as m:
            if not hold:
                unheld(m)
            svc, prover = service(name, tmp_path, m)
            with collections_by_generation() as seen:
                proof_hex, primary = getattr(svc, f"gen_{name}_proof")(
                    *gen_args)
            assert gc.isenabled()
            assert getattr(svc, f"verify_{name}_proof")(proof_hex, *ver_args)
            out.append((proof_hex, primary, prover.calls, sum(seen.values())))
    with_hold, without = out
    assert with_hold[:3] == without[:3]
    assert with_hold[2][0][0] == with_hold[1]
    # the collector ran through the synthesis without the hold only
    assert without[3] > with_hold[3]


@pytest.mark.parametrize("name", CIRCUITS)
def test_no_collection_under_notes_or_witness(name, tmp_path, monkeypatch,
                                              recorder):  # noqa: F811
    svc, _ = service(name, tmp_path, monkeypatch)
    gen_args, _ = circuit_args(name)
    getattr(svc, f"gen_{name}_proof")(*gen_args)
    with monkeypatch.context() as m:
        unheld(m)
        getattr(svc, f"gen_{name}_proof")(*gen_args)
    spans.disable()
    names = by_name(spans.drain())
    (held_notes, _), (held_wit, unheld_wit) = (names["zktx.notes"],
                                               names["zktx.witness"])
    assert held_wit.info == {"gc_held": 1}
    assert unheld_wit.info == {"gc_held": 0}
    parents = collections.Counter(s.parent for s in names.get("host.gc", []))
    assert parents[held_notes.id] == parents[held_wit.id] == 0
    # the recorder sees the collections the hold keeps out
    assert parents[unheld_wit.id] > 0


def test_hold_keeps_a_disabled_collector_disabled():
    gc.disable()
    with api.hold_gc() as held:
        assert held == 0 and not gc.isenabled()
    assert not gc.isenabled()


def test_holds_nest_and_restore_the_collector_when_the_block_raises():
    with api.hold_gc() as outer:
        with api.hold_gc() as inner:
            assert outer == inner == 1 and not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(ValueError):
        with api.hold_gc():
            with api.hold_gc():
                raise ValueError
    assert gc.isenabled()
    assert api._gc_holds == 0


def test_overlapping_holds_on_two_threads_restore_the_collector_after_both():
    held, states = [], []

    def hold(entered, release):
        with api.hold_gc() as h:
            held.append(h)
            entered.set()
            release.wait()

    events = [(threading.Event(), threading.Event()) for _ in range(2)]
    threads = [threading.Thread(target=hold, args=e) for e in events]
    for t, (entered, _) in zip(threads, events):
        t.start()
        assert entered.wait(10)
    states.append(gc.isenabled())
    for t, (_, release) in zip(threads, events):
        release.set()
        t.join(10)
        states.append(gc.isenabled())
    assert held == [1, 1]
    assert states == [False, False, True]


def test_many_threads_holding_at_once_keep_the_count():
    """More threads than cores open and close holds with a short switch
    interval: inside every hold the collector is off, and after the last
    it is on with no hold counted."""
    threads_n, rounds = 2 * (os.cpu_count() or 1) + 2, 200
    off_inside = []

    def hold():
        ok = True
        for _ in range(rounds):
            with api.hold_gc() as h:
                ok &= h == 1 and not gc.isenabled()
        off_inside.append(ok)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hold) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert off_inside == [True] * threads_n
    assert gc.isenabled() and api._gc_holds == 0
