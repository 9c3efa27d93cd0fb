"""blockmaze_tpu_torch end to end on the CPU (plain versions of every
kernel): port keygen, port Prover, and both the JAX package's host
verifier and the port's copy of it accept, on both evaluation-domain kinds: chain_circuit(120) (basic, m = 128) and
chain_circuit(46) (step, m = 48 = 32 + 16, the mint shape big_m = 2 small_m).
The circuit is the JAX package's Protoboard, which the port's keygen takes
as it is.
"""

import random

import pytest
import torch

from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import generator, keys, verifier
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.ntt import domain as D

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)


@pytest.mark.parametrize("ncons,kind", [(120, D.BasicDomain),
                                        (46, D.StepDomain)],
                         ids=["basic128", "step48"])
def test_keygen_prove_verify(ncons, kind):
    pb = chain_circuit(ncons)
    toxic = random.Random(ncons)
    pk, vk = generator.generate(pb, "cpu",
                                rng=lambda: toxic.randrange(1, R_MOD))
    prover = Prover(keys.build_device_pk(pk), "cpu", lanes=64, window=4)
    assert isinstance(prover.domain, kind)
    proof = prover.prove(pb.primary_input(), pb.auxiliary_input())
    bad = [(pb.primary_input()[0] + 1) % R_MOD]
    for verify in (jverifier.verify, verifier.verify):
        assert verify(vk, pb.primary_input(), proof)
        assert not verify(vk, bad, proof)
