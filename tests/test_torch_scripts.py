"""The port's operator drivers (blockmaze_tpu_torch/scripts) on the CPU,
where every kernel wrapper runs its plain version, at small sizes:
msmbench's blinded MSM and its phase split against the closed form;
scaling's blinded sharded MSM on a mesh of 2 CPU shards against the closed
form and the single-device MSM; e2e's and batch's work functions on a
chain circuit with seeded keys, each proof equal to Prover.prove at the
same (r, s), accepted by the JAX package's host verifier and the port's,
and rejected by both for a wrong primary input; key resolution through
--key-dir (a text key written with write_proving_key) against the seeded
cache; and every driver's --help and its no-card error.
"""

import random

import pytest
import torch

from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import generator, verifier
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.parallel import mesh as pm
from blockmaze_tpu_torch.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.scripts import (_common, batch, bench, depth20,
                                         e2e, lifecycle, msmbench, prewarm,
                                         scaling, warmstart)
from blockmaze_tpu_torch.serialization import libsnark_io as io

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 1 << 7
WINDOW, LANES = 4, 64      # every plain MSM pays ~254 sequential doublings
NCONS = 6                  # chain circuit: 7 variables, basic domain m = 8
DRIVERS = {"msmbench": msmbench, "warmstart": warmstart, "e2e": e2e,
           "batch": batch, "depth20": depth20, "lifecycle": lifecycle,
           "scaling": scaling, "prewarm": prewarm, "bench": bench}


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_synth_points_tile_the_first_64_multiples(curve):
    G, mul, conv = ((HC.g1_generator(), HC.g1_mul, tc.g1_affine_to_device)
                    if curve == "g1" else
                    (HC.g2_generator(), HC.g2_mul, tc.g2_affine_to_device))
    X, Y, inf = msmbench.synth_points(N, curve, CPU)
    idx = [0, 1, 63, 64, 65, N - 1]
    x, y, _ = conv([mul(G, i % 64 + 1) for i in idx])
    assert torch.equal(X[idx], tf.to_tensor(x, CPU))
    assert torch.equal(Y[idx], tf.to_tensor(y, CPU))
    assert not inf.any()


def test_msmbench_closed_form_and_phase_split():
    pts, ks, sc, blind = msmbench.inputs(N, "g1", CPU)
    want = msmbench.closed_form("g1", ks)
    res, times = msmbench.bench("g1", pts, sc, WINDOW, LANES, 1, CPU, blind)
    assert res == want and len(times) == 1
    split, phases = msmbench.phase_split("g1", pts, sc, WINDOW, LANES, 1,
                                         CPU, blind)
    assert list(phases) == ["live_stream", "accumulate", "combine",
                            "triangle", "fold"]
    assert split == want


def test_msmbench_blinded_as_the_prover():
    """The blinded MSM (the exception-free accumulation) before its blind
    is taken out differs from the unblinded one, and after equals it."""
    pts, ks, sc, (R, rxy) = msmbench.inputs(N, "g1", CPU)
    plain = msmbench.to_host("g1", pp.msm("g1", pts, sc, WINDOW, LANES))
    res = pp.msm("g1", pts, sc, WINDOW, LANES, blind=rxy)
    assert msmbench.to_host("g1", res) != plain
    assert msmbench.unblinded("g1", res, R, WINDOW) == plain


def test_scaling_two_cpu_shards(tmp_path):
    X, Y, inf = scaling.synthetic_points(N, cache=str(tmp_path))
    again = scaling.synthetic_points(N, cache=str(tmp_path))   # the npz
    assert all((a == b).all() for a, b in zip((X, Y, inf), again))
    pts = (tf.to_tensor(X, CPU), tf.to_tensor(Y, CPU), torch.from_numpy(inf))
    ks, sc = msmbench.seeded_scalars(N, CPU, seed=11)
    want = HC.g1_mul(HC.g1_generator(),
                     sum((i + 1) * k for i, k in enumerate(ks)) % R_MOD)
    R, rxy = blind = pp.make_blind("g1", CPU)
    got, _ = scaling.mesh_msm(pm.Mesh([CPU] * 2), pts, sc, WINDOW, LANES, 0,
                              blind)
    single = msmbench.unblinded("g1", pp.msm("g1", pts, sc, WINDOW, LANES,
                                             blind=rxy), R, WINDOW)
    assert got == want and single == want


@pytest.fixture(scope="module")
def chain_keys(tmp_path_factory):
    """Seeded keys of chain_circuit(NCONS) through _common.resolve_keys:
    keygen into a fresh cache, then the cached keys without synthesis."""
    cache = str(tmp_path_factory.mktemp("keys"))
    made = _common.resolve_keys("chain", CPU, make_pb=lambda: chain_circuit(
        NCONS), cache=cache)
    assert made.source == "keygen"
    keys = _common.resolve_keys(
        "chain", CPU, make_pb=lambda: pytest.fail("synthesised on a hit"),
        cache=cache)
    assert keys.source == "seeded cache"
    return cache, keys


def test_key_dir_text_key_equals_seeded_cache(chain_keys, tmp_path):
    cache, _ = chain_keys
    toxic = random.Random(_common.SEED)
    pk, vk = generator.generate(chain_circuit(NCONS), "cpu",
                                rng=lambda: toxic.randrange(1, R_MOD))
    io.write_proving_key(str(tmp_path / "chainpk.txt"), pk)
    io.write_verification_key(str(tmp_path / "chainvk.txt"), vk)
    keys = _common.resolve_keys("chain", CPU, key_dir=str(tmp_path))
    assert keys.source == "key dir"
    assert _common.key_digests(str(tmp_path / "chainpk.v1.npz"),
                               keys.vk_path) == \
        _common.key_digests(*generator.cache_paths("chain", _common.SEED,
                                                   cache))


def _accepted(vk, primary, proof):
    """Both verifiers accept the proof and reject it for another input."""
    bad = [(primary[0] + 1) % R_MOD] + list(primary[1:])
    return all(v(vk, primary, proof) and not v(vk, bad, proof)
               for v in (jverifier.verify, verifier.verify))


@pytest.fixture(scope="module")
def e2e_run(chain_keys):
    _, keys = chain_keys
    pb = chain_circuit(NCONS)
    row, proof = e2e.prove_and_verify("chain", pb, keys, CPU, 1, LANES,
                                      WINDOW)
    return keys, pb, row, proof


def test_e2e_proof_verifies(e2e_run):
    keys, pb, row, proof = e2e_run
    assert row["verified"] and row["oracle"] is None
    assert (row["n"], row["m"]) == (NCONS + 1, NCONS + 2)
    assert _accepted(keys.vk, pb.primary_input(), proof)


@pytest.fixture(scope="module")
def batch_run(chain_keys):
    """prove_batches of two chain witnesses at (r, s) = (12345, 67890)
    (e2e's) and (2, 52)."""
    _, keys = chain_keys
    prover = Prover(keys.dpk, CPU, lanes=LANES, window=WINDOW)
    insts = [(pb.primary_input(), pb.auxiliary_input())
             for pb in (chain_circuit(NCONS), chain_circuit(NCONS, 5))]
    rs = [(*e2e.FIRST_RS,), (2, 52)]
    try:
        times, proofs = batch.prove_batches(
            prover, keys.vk, insts, [r for r, _ in rs], [s for _, s in rs],
            0, CPU)
    finally:
        prover.close()
    assert len(times) == 1
    return keys, prover, insts, rs, proofs


@pytest.mark.parametrize("slot", [0, 1])
def test_batch_proof_equals_prove(batch_run, e2e_run, slot):
    keys, prover, insts, rs, proofs = batch_run
    if slot == 0:       # e2e's proof: Prover.prove at the same witness, (r, s)
        want = e2e_run[3]
    else:
        want = prover.prove(*insts[slot], r=rs[slot][0], s=rs[slot][1])
    got = proofs[slot]
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert _accepted(keys.vk, insts[slot][0], got)


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_help_exits_zero(name, capsys):
    with pytest.raises(SystemExit) as e:
        DRIVERS[name].main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRIVERS[name].main([])
