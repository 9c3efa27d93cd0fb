"""blockmaze_tpu_torch's Prover on a mesh of CPU shards on the step domain
(chain_circuit(46): m = 48 = 32 + 16, mint's shape big_m = 2 small_m):
prove_batch on a 2-shard mesh gives the JAX package's single-chip proof
at (r, s) = (7, 9), and both verifiers accept it and reject a wrong
input. The basic domain and prove itself: test_torch_sharded_prover.py."""

import pytest
import torch

from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.parallel import mesh as pm

from test_torch_sharded_prover import (LANES, WINDOW, R, S, check_proof,
                                       jax_reference)

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def step():
    return jax_reference(46, "step")


def test_mesh_prove_batch_equals_jax_single_chip(step):
    pb, dpk, vk, want = step
    prover = Prover(dpk, lanes=LANES, window=WINDOW,
                    mesh=pm.Mesh(["cpu"] * 2))
    assert prover.sharded_qap, "the circuit must take the sharded QAP"
    try:
        got = prover.prove_batch([(pb.primary_input(),
                                   pb.auxiliary_input())], rs=[R], ss=[S])
    finally:
        prover.close()
    assert len(got) == 1
    check_proof(vk, pb, got[0], want)
