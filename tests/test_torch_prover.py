"""blockmaze_tpu_torch keygen and prover against the JAX package on the
toy circuit of tests/test_keygen.py (plain versions of every kernel, on the
CPU): the same toxic waste gives equal keys, and the same JAX-built key and
(r, s) give an equal proof, also after the key went through the JAX
package's v1 npz cache. The two packages have their own key and proof
classes, so keys compare as dictionaries of their fields and proofs field
by field."""

import dataclasses

import numpy as np
import pytest
import torch

from blockmaze_tpu.fields.constants import R_MOD
from blockmaze_tpu.groth16 import generator as jgen
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu.groth16.prover import Prover as JaxProver
from blockmaze_tpu_torch.groth16 import generator, keys, verifier
from blockmaze_tpu_torch.groth16.prover import Prover

from test_keygen import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

TOXIC = [11, 13, 17, 19, 23]


@pytest.fixture(scope="module")
def jax_reference():
    w = 1234567
    pb = toy_circuit(w * w % R_MOD, w)
    it = iter(TOXIC)
    pk, vk = jgen.generate(pb, rng=lambda: next(it))
    dpk = jkeys.build_device_pk(pk)
    proof = JaxProver(dpk, lanes=8, window=8).prove(
        pb.primary_input(), pb.auxiliary_input(), r=7, s=9)
    return pb, pk, vk, dpk, proof


def test_generate_matches_jax(jax_reference):
    pb, pk, vk, _, _ = jax_reference
    it = iter(TOXIC)
    tpk, tvk = generator.generate(pb, "cpu", rng=lambda: next(it))
    assert dataclasses.asdict(tpk) == dataclasses.asdict(pk)
    assert dataclasses.asdict(tvk) == dataclasses.asdict(vk)


def test_build_device_pk_matches_jax(jax_reference):
    _, pk, _, dpk, _ = jax_reference
    tdpk = keys.build_device_pk(pk)
    for f in ("A", "B2", "B1", "H", "L"):
        assert all(np.array_equal(a, b)
                   for a, b in zip(getattr(tdpk, f), getattr(dpk, f)))
    for f in ("B_idx", "a_row", "a_var", "a_coeff", "b_row", "b_var",
              "b_coeff", "c_row", "c_var", "c_coeff"):
        assert np.array_equal(getattr(tdpk, f), getattr(dpk, f)), f


@pytest.fixture(scope="module")
def npz_key(jax_reference, tmp_path_factory):
    """The JAX-built key written by the JAX package's save_device_pk and
    read back by the port's load_device_pk."""
    path = str(tmp_path_factory.mktemp("keys") / "toy.v1.npz")
    jkeys.save_device_pk(jax_reference[3], path)
    return keys.load_device_pk(path)


def test_jax_npz_loads_identically(jax_reference, npz_key, tmp_path):
    dpk = jax_reference[3]
    for f in keys._INT_FIELDS + keys._G1_CONSTS + keys._G2_CONSTS:
        assert getattr(npz_key, f) == getattr(dpk, f), f
    for f in keys._POINT_FIELDS:
        assert all(np.array_equal(a, b)
                   for a, b in zip(getattr(npz_key, f), getattr(dpk, f))), f
    for f in ["B_idx"] + keys._COO_FIELDS:
        assert np.array_equal(getattr(npz_key, f), getattr(dpk, f)), f
    # the port takes the JAX DevicePK object as is, to the same tensors
    a, b = keys.to_device(dpk, "cpu"), keys.to_device(npz_key, "cpu")
    for f in ("A", "B2", "B1", "H", "L"):
        assert all(torch.equal(x, y)
                   for x, y in zip(getattr(a, f), getattr(b, f))), f
    for f in ("ptr", "var", "coeff", "long_rows"):
        assert torch.equal(getattr(a.csr, f), getattr(b.csr, f)), f
    # and the port's own npz loads back into the JAX package
    path = str(tmp_path / "toy_port.v1.npz")
    keys.save_device_pk(npz_key, path)
    back = jkeys.load_device_pk(path)
    assert all(np.array_equal(x, y) for x, y in zip(back.A, dpk.A))
    assert back.delta_g2 == dpk.delta_g2


def test_prove_matches_jax(jax_reference, npz_key):
    """Same JAX-built key (through the JAX-written npz) and (r, s) = (7, 9):
    the port's proof equals the JAX package's, and both the JAX package's
    verifier and the port's copy accept it and reject a wrong input."""
    pb, _, vk, _, proof = jax_reference
    got = Prover(npz_key, "cpu", lanes=64, window=4).prove(
        pb.primary_input(), pb.auxiliary_input(), r=7, s=9)
    assert (got.a, got.b, got.c) == (proof.a, proof.b, proof.c)
    bad = [(pb.primary_input()[0] + 1) % R_MOD]
    for verify in (jverifier.verify, verifier.verify):
        assert verify(vk, pb.primary_input(), got)
        assert not verify(vk, bad, got)
