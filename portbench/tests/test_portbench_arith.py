"""The benchmark's arithmetic: rates over the whole window, the p90 over
every request, the device's idle share from an interval list, and the
seeded traffic."""

import statistics
import types

import pytest

from portbench import loops, peaks, spec
from portbench.trace import Trace, union
from portbench.tests.conftest import REPO

METRICS = f"{REPO}/portbench/metrics"


def reader(name):
    return spec.load_module(f"{METRICS}/{name}.py")


def fake_run(kind, records, window_s=5.0, tr=None, work=()):
    return types.SimpleNamespace(kind=kind, records=records,
                                 window_s=window_s, setup_s=1.5, trace=tr,
                                 work=list(work))


def test_rates_take_the_whole_window():
    recs = [{"t0": i, "t1": i + 0.5, "timings": {}} for i in range(10)]
    assert reader("proofs_per_s").read(fake_run("prove", recs)) == 2.0
    batches = [{"proofs": [0] * 8, "timings": {}} for _ in range(3)]
    assert reader("proofs_per_s").read(fake_run("batch", batches)) == 4.8
    assert reader("tx_per_s").read(fake_run("tx", recs)) == 2.0
    assert reader("proofs_per_s").read(fake_run("tx", recs)) is None
    assert reader("setup_s").read(fake_run("tx", recs)) == 1.5


def test_p90_over_every_request():
    lat = [0.1 * (i + 1) for i in range(20)]
    recs = [{"t0": 0.0, "t1": x} for x in lat]
    got = reader("proof_p90_s").read(fake_run("prove", recs))
    assert got == pytest.approx(statistics.quantiles(
        lat, n=10, method="inclusive")[8])
    assert 1.8 <= got <= 1.9


def test_idle_share_from_intervals():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 6.0, 7.0)]
    spans = union((s, e) for _, s, e in ops)
    assert spans == [[0.0, 2.0], [6.0, 7.0]]
    tr = Trace(ops, (0.0, 10.0), sum(e - s for s, e in spans), spans)
    run = fake_run("prove", [], tr=tr)
    assert reader("device.idle_pct.prove").read(run) == pytest.approx(70.0)
    assert reader("device.idle_pct.batch").read(run) is None
    assert tr.op_seconds(lambda n: n == "a") == (2.0, 2)
    assert tr.by_name() == [["a", 2.0], ["b", 1.5]]
    idle = dict(tr.idle_by_phase([("combine", 2.0, 5.0),
                                  ("wires", 7.0, 9.0)]))
    assert idle == pytest.approx({"combine": 3.0, "wires": 2.0,
                                  "between requests": 2.0})


def test_roofline_share_is_bound_over_kernel_time():
    ops = [("void accumulate_kernel<bm::Fq, 1>", 0.0, 0.004),
           ("fft", 0.004, 0.005)]
    tr = Trace(ops, (0.0, 1.0), 0.005, [(0.0, 0.005)])
    recs = [{"slot": 0}, {"slot": 1}]
    work = [{"bound_s": 0.001}, {"bound_s": 0.0005}]
    got = reader("msm_round_roofline").read(fake_run("prove", recs, tr=tr,
                                                     work=work))
    assert got == pytest.approx(37.5)
    assert reader("msm_round_roofline").read(fake_run("prove", recs)) is None


def test_msm_round_counts():
    import torch
    # scalars 1 (one live window), 0 (none), 2^12 + 1 (two at c = 12);
    # the third point at infinity
    sc = torch.zeros((3, 16), dtype=torch.int32)
    sc[0, 0] = 1
    sc[2, 0] = 1
    sc[2, 0] |= 1 << 12
    inf = torch.tensor([False, False, False])
    live, nbytes = peaks.msm_round_counts("g1", inf, sc, 12, 65536, 4)
    assert live == 3
    W = -(-254 // 12)
    assert nbytes == 1 * 3 * 8 + 2 * 129 + 2 * 192 + 12 + W * 4096 * 196
    live, _ = peaks.msm_round_counts("g1", torch.tensor([False, False,
                                                         True]), sc, 12,
                                     65536, 4)
    assert live == 1
    assert peaks.bound_s(10**6, 0)[1] == "ops"
    assert peaks.bound_s(0, 10**9)[1] == "bytes"


@pytest.mark.parametrize("name", ["mint", "deposit"])
def test_seeded_pool(name):
    ref = spec.load_module(f"{REPO}/portbench/configs/{name}_ref.py")
    seed = 2**31 + 77

    def pool(s):
        rng = loops.stream(s, "pool")
        return [ref.transaction(rng) for _ in range(4)]

    a, b = pool(seed), pool(seed)
    assert a == b
    assert len({repr(tx) for tx in a}) == 4
    assert pool(seed + 1) != a
    d1, d2 = loops.stream(seed, "draws"), loops.stream(seed, "draws")
    assert [d1.random() for _ in range(3)] == [d2.random() for _ in range(3)]
