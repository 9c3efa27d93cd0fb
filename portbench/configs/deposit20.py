"""Deposit at the production Merkle depth 20 on the port: the circuit
instance deposit20 (840,451 constraints, basic QAP domain 2^20) and
deposit.py's witness at the configuration's depth."""

import os

from blockmaze_tpu_torch.circuits import instances
from portbench import spec

CIRCUIT = "deposit20"

_deposit = spec.load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "deposit.py"))


def protoboard():
    """The circuit with its constraints, for keygen."""
    return instances.protoboard(CIRCUIT)


# (primary, aux) of a transaction at config["merkle_depth"]
witness = _deposit.witness
