"""blockmaze_tpu_torch's Prover.prove_batch and keys.load_or_build against
the JAX package on the toy circuit of tests/test_keygen.py (plain versions
of every kernel, on the CPU): the batch's proofs equal the JAX package's
prove_batch and the port's single prove at equal (r, s), and a
libsnark-format key loads, through its npz cache, to the same DevicePK in
both packages. Keys compare as dictionaries of their fields, proofs field
by field."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from blockmaze_tpu.fields.constants import R_MOD
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu.groth16.prover import Prover as JaxProver
from blockmaze_tpu.serialization import libsnark_io as jio
from blockmaze_tpu_torch.groth16 import keys, verifier
from blockmaze_tpu_torch.groth16.prover import Prover

from test_keygen import toy_circuit
from test_torch_prover import jax_reference  # noqa: F401  (fixture)

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

RS, SS = [7, 3], [9, 5]


def fields(proof):
    return proof.a, proof.b, proof.c


def combine_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prover-combine") and t.is_alive()]


@pytest.fixture(scope="module")
def instances(jax_reference):
    pb = jax_reference[0]
    w2 = 424242
    pb2 = toy_circuit(w2 * w2 % R_MOD, w2)
    return [(pb.primary_input(), pb.auxiliary_input()),
            (pb2.primary_input(), pb2.auxiliary_input())]


def test_prove_batch_matches_jax_and_prove(jax_reference, instances):
    """The port's batch equals the JAX package's batch at the same (rs,
    ss), its first proof equals the port's single prove at (7, 9), and
    both verifiers accept each proof for its own instance only. close()
    leaves no combine thread alive, and a batch after it starts one again
    and still equals prove."""
    _, pk, vk, jdpk, _ = jax_reference
    want = JaxProver(jdpk, lanes=8, window=8).prove_batch(instances, rs=RS,
                                                          ss=SS)
    prover = Prover(keys.build_device_pk(pk), "cpu", lanes=64, window=4)
    try:
        got = prover.prove_batch(instances, rs=RS, ss=SS)
    finally:
        prover.close()
    assert prover._pool is None and not combine_threads()
    assert [fields(p) for p in got] == [fields(p) for p in want]
    single = prover.prove(*instances[0], r=RS[0], s=SS[0])
    assert fields(got[0]) == fields(single)
    try:
        again = prover.prove_batch(instances[:1], rs=RS[:1], ss=SS[:1])
        assert len(combine_threads()) == 1
    finally:
        prover.close()
    assert not combine_threads()
    assert [fields(p) for p in again] == [fields(single)]
    for verify in (jverifier.verify, verifier.verify):
        for i, proof in enumerate(got):
            assert verify(vk, instances[i][0], proof)
            assert not verify(vk, instances[1 - i][0], proof)


def test_prove_batch_checks_sizes(jax_reference, instances):
    prover = Prover(keys.build_device_pk(jax_reference[1]), "cpu")
    with pytest.raises(ValueError, match="auxiliary input"):
        prover.prove_batch([instances[0], (instances[1][0], [])])
    with pytest.raises(ValueError, match="2 instances, 1 r"):
        prover.prove_batch(instances, rs=[1], ss=[1, 2])
    assert prover.prove_batch([]) == []


def dpk_dict(dpk):
    return {f.name: getattr(dpk, f.name) for f in dataclasses.fields(dpk)}


def test_load_or_build_matches_jax(jax_reference, tmp_path):
    """A miss parses the text key (on the CPU: the tokenizer and the
    decompression kernels' plain versions) and writes <base>.v1.npz
    beside it, a hit loads that file; both give the DevicePK the JAX
    package's load_or_build gives for the same file, and the two npz files
    hold the same arrays."""
    pk = jax_reference[1]
    path = str(tmp_path / "toypk.txt")
    jio.write_proving_key(path, pk)
    cache = str(tmp_path / "toypk.v1.npz")
    assert not os.path.exists(cache)
    built = keys.load_or_build(path, device="cpu")
    assert os.path.exists(cache)
    stamp = os.path.getmtime(cache)
    loaded = keys.load_or_build(path, device="cpu")
    assert os.path.getmtime(cache) == stamp
    os.makedirs(tmp_path / "jax")
    want = dpk_dict(jkeys.load_or_build(path, str(tmp_path / "jax")))
    with np.load(cache) as got_z, \
            np.load(str(tmp_path / "jax" / "toypk.v1.npz")) as want_z:
        assert sorted(got_z.files) == sorted(want_z.files)
        for k in want_z.files:
            assert got_z[k].dtype == want_z[k].dtype, k
            assert np.array_equal(got_z[k], want_z[k]), k
    for got in (dpk_dict(built), dpk_dict(loaded)):
        assert got.keys() == want.keys()
        for name, value in want.items():
            if isinstance(value, tuple) and isinstance(value[0], np.ndarray):
                assert all(np.array_equal(a, b)
                           for a, b in zip(got[name], value)), name
            elif isinstance(value, np.ndarray):
                assert np.array_equal(got[name], value), name
            else:
                assert got[name] == value, name
