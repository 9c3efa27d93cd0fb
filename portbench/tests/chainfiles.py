"""A toy configuration for the CPU tests: the chain circuit of
blockmaze_tpu_torch.r1cs.examples (w_{i+1} = w_i^2, public x = w_last),
written into a copy of the checkout as new files only."""

CONFIG_PY = '''
"""The chain circuit on the port, and a service for it with ZkTx's surface
(circuits[name].prover and .vk), proving and verifying its statement."""

from blockmaze_tpu_torch.groth16 import verifier
from blockmaze_tpu_torch.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.serialization import libsnark_io as io
from blockmaze_tpu_torch.zktx.api import CircuitContext


class Service:
    def __init__(self, key_dir, device):
        self.circuits = {"chain": CircuitContext("chain", key_dir, device)}


def service(key_dir, config, device):
    svc = Service(key_dir, device)
    svc.circuits["chain"].prover
    return svc


def prove_tx(svc, tx):
    primary, aux = witness(tx, {"constraints": 12})
    proof = svc.circuits["chain"].prover.prove(primary, aux)
    return io.proof_to_hex(proof), primary


def verify_tx(svc, tx, proof_hex):
    primary, _ = witness(tx, {"constraints": 12})
    return verifier.verify(svc.circuits["chain"].vk, primary,
                           io.proof_from_hex(proof_hex))


def protoboard():
    return chain_circuit(12, 3)


def witness(tx, config):
    pb = chain_circuit(config["constraints"], tx["w0"])
    return pb.primary_input(), pb.auxiliary_input()
'''

CONFIG_REF_PY = '''
"""The chain circuit's plain reference."""

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def transaction(rng):
    return {"w0": rng.randrange(2, R)}


def statement(tx, config):
    x = tx["w0"]
    for _ in range(config["constraints"] - 1):
        x = x * x % R
    return [x]
'''

METRIC_PY = '''
"""Proofs in the window: a metric added as a file of its own."""


def read(run):
    return float(len(run.records)) if run.records else None
'''
