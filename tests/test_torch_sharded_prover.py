"""blockmaze_tpu_torch's Prover on a mesh of CPU shards (mesh=...) and the
sharded QAP (parallel/sqap.py), against the JAX package: on the basic
domain (chain_circuit(30), m = 32) the mesh Prover's proof at (r, s) =
(7, 9) over 2 shards equals the JAX package's single-chip Prover's, as
the JAX package's own slow test pins its mesh proof to its single-chip
proof, and both verifiers accept it and reject a wrong input (the step
domain: test_torch_sharded_prover_step.py); the Prover's placement on a
mesh; sharded_matvec against the JAX package's and the integer sum;
sharded_qap_h against the single-device qap_h_arrays on both domain
kinds. Keys come from the JAX package's keygen with fixed toxic waste;
every comparison is exact.

The circuits are small because the JAX single-chip Prover's first proof
in a process is minutes of XLA compilation on the CPU at m = 256, and a
2-shard mesh proof is ten plain MSMs."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.groth16 import generator as jgen
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu.groth16.prover import Prover as JaxProver
from blockmaze_tpu.parallel import mesh as jmesh
from blockmaze_tpu.parallel import sqap as jsqap
from blockmaze_tpu.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import keys, qap, verifier
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.ntt import domain as D
from blockmaze_tpu_torch.ntt import tntt
from blockmaze_tpu_torch.parallel import mesh as pm
from blockmaze_tpu_torch.parallel import sntt, sqap

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

FR = tf.FR
R, S = 7, 9
# the port's Prover on the mesh (its proofs do not depend on these)
LANES, WINDOW = 64, 6


def fields(proof):
    return proof.a, proof.b, proof.c


def jax_reference(ncons: int, kind: str):
    """(protoboard, the port's DevicePK, vk, the JAX single-chip proof at
    (R, S)) of chain_circuit(ncons), keys from the JAX keygen."""
    pb = chain_circuit(ncons)
    toxic = iter([11, 13, 17, 19, 23])
    pk, vk = jgen.generate(pb, rng=lambda: next(toxic))
    jdpk = jkeys.build_device_pk(pk)
    assert jdpk.domain.kind == kind
    proof = JaxProver(jdpk, lanes=8, window=8).prove(
        pb.primary_input(), pb.auxiliary_input(), r=R, s=S)
    return pb, keys.build_device_pk(pk), vk, proof


def check_proof(vk, pb, got, want):
    """got equals the JAX proof; both verifiers accept it for pb's input
    and reject it for another."""
    assert fields(got) == fields(want)
    bad = [(pb.primary_input()[0] + 1) % R_MOD]
    for verify in (jverifier.verify, verifier.verify):
        assert verify(vk, pb.primary_input(), got)
        assert not verify(vk, bad, got)


@pytest.fixture(scope="module")
def basic():
    return jax_reference(30, "basic")


def test_mesh_prover_equals_jax_single_chip(basic):
    pb, dpk, vk, want = basic
    prover = Prover(dpk, lanes=LANES, window=WINDOW,
                    mesh=pm.Mesh(["cpu"] * 2))
    assert prover.device == torch.device("cpu")
    assert prover.sharded_qap, "the circuit must take the sharded QAP"
    got = prover.prove(pb.primary_input(), pb.auxiliary_input(), r=R, s=S)
    assert set(prover.timings) == {"wires", "qap", "msm", "combine"}
    check_proof(vk, pb, got, want)


def test_mesh_prover_placement(basic):
    """Each MSM's points in one block per shard; every MSM at least as
    large as the mesh (padded with infinity points); a domain the mesh
    cannot split (m = 32 over 16 shards) takes the single-device QAP."""
    dpk = basic[1]
    prover = Prover(dpk, lanes=LANES, window=WINDOW,
                    mesh=pm.Mesh(["cpu"] * 16))
    assert not prover.sharded_qap
    assert len(prover.A) == 16
    assert all(p[0].shape[0] == prover.nA // 16 for p in prover.A)
    wide = Prover(dpk, lanes=LANES, window=WINDOW,
                  mesh=pm.Mesh(["cpu"] * 64))
    assert min(wide.nA, wide.nB, wide.nH, wide.nL) == 64
    assert bool(wide.H[-1][2].all())           # the padding: infinity


def _coo(rng, m, nvars, T, long_row=None):
    """T random terms (row, var, coefficient) of an m-row matrix; with
    long_row, 40 more terms on that row (more than keys.LONG_ROW)."""
    row = rng.randint(0, m, T)
    if long_row is not None:
        row = np.concatenate([row, np.full(40, long_row)])
    var = rng.randint(0, nvars, row.shape[0])
    coeff = [int(rng.randint(1, 1 << 30)) for _ in range(row.shape[0])]
    return row.astype(np.int32), var.astype(np.int32), coeff


def test_sharded_matvec_matches_jax_and_integers():
    """T = 333 terms (not a multiple of 8) over 8 shards: the port's
    sharded_matvec equals the JAX package's and the integer sum."""
    rng = np.random.RandomState(3)
    m, nvars, T = 64, 40, 333
    row, var, coeff_i = _coo(rng, m, nvars, T)
    wit_i = [int(rng.randint(1, 1 << 30)) for _ in range(nvars)]
    coeff, wit = tf.to_mont_host(FR, coeff_i), tf.to_mont_host(FR, wit_i)
    mesh = pm.Mesh(["cpu"] * 8)
    csr = keys.csr_to(keys.coo_to_csr(row, var, coeff, m), "cpu")
    got = sqap.sharded_matvec(mesh, sqap.shard_csr(mesh, csr),
                              tf.to_tensor(wit, "cpu"))
    want = [0] * m
    for t in range(T):
        want[row[t]] = (want[row[t]] + coeff_i[t] * wit_i[var[t]]) % R_MOD
    assert tf.from_mont_host(FR, got.numpy()) == want
    rowp, varp, coeffp = jsqap._pad_terms(row, var, coeff, 8, m)
    jgot = jsqap.sharded_matvec(
        jmesh.make_mesh(8), jnp.asarray(rowp), jnp.asarray(varp),
        jnp.asarray(coeffp), jnp.asarray(wit), m)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(jgot))


def test_shard_csr_blocks():
    """The shards' rows are the CSR's rows in order, about equal in terms,
    each shard's ptr from 0 and its long rows counted from its start."""
    rng = np.random.RandomState(5)
    m = 48
    row, var, coeff = _coo(rng, m, 10, 200, long_row=37)
    csr = keys.csr_to(keys.coo_to_csr(row, var, tf.to_mont_host(FR, coeff),
                                      m), "cpu")
    shards = sqap.shard_csr(pm.Mesh(["cpu"] * 4), csr)
    assert [(s.start, s.stop) for s in shards][0][0] == 0
    assert shards[-1].stop == m
    for a, b in zip(shards, shards[1:]):
        assert a.stop == b.start
    for s in shards:
        p0 = int(csr.ptr[s.start])
        assert torch.equal(s.csr.ptr, csr.ptr[s.start:s.stop + 1] - p0)
        assert torch.equal(s.csr.var, csr.var[p0:p0 + int(s.csr.ptr[-1])])
        assert s.csr.ptr[-1] <= -(-csr.ptr[-1] // 4) + 40
    longs = [int(r) + s.start for s in shards for r in s.csr.long_rows]
    assert longs == csr.long_rows.tolist() == [37]


@pytest.mark.parametrize("n,shards", [(120, 8), (120, 2), (80, 2), (80, 4)],
                         ids=["basic128-8", "basic128-2", "step96-2",
                              "step96-4"])
@pytest.mark.parametrize("std", [False, True], ids=["mont", "std"])
def test_sharded_qap_h_matches_single_device(n, shards, std):
    """sharded_qap_h equals qap_h_arrays on one device (Montgomery and
    standard form), on a random stacked A/B/C CSR with a long row."""
    dom = D.get_evaluation_domain(n)
    m = dom.m
    assert dom.kind == ("basic" if n == 120 else "step")
    rng = np.random.RandomState(n + shards)
    nvars = 30
    row, var, coeff = _coo(rng, 3 * m, nvars, 6 * m, long_row=m + 5)
    csr = keys.csr_to(keys.coo_to_csr(row, var, tf.to_mont_host(FR, coeff),
                                      3 * m), "cpu")
    r = random.Random(n)
    w = tf.to_tensor(tf.to_mont_host(FR, [r.randrange(R_MOD)
                                          for _ in range(nvars)]), "cpu")
    T1 = tntt.tables_to({**tntt.qap_tables(dom), **tntt.std_tables(dom)},
                        "cpu")
    want = qap.qap_h_arrays(dom, csr, w, T1, std=std)
    mesh = pm.Mesh(["cpu"] * shards)
    assert sqap.can_shard_domain(dom, shards)
    T = sntt.tables_to(sntt.sqap_tables(dom, shards), mesh)
    got = sqap.sharded_qap_h(mesh, dom, sqap.shard_csr(mesh, csr), w, T,
                             std=std)
    assert torch.equal(got, want)
