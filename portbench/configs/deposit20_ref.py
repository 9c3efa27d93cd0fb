"""Deposit at Merkle depth 20: deposit_ref.py's transactions (a tree of 16
commitments, the transfer note's at a leaf drawn from the stream) and its
statement, whose root notes.merkle_root takes over config["merkle_depth"]
levels."""

import os

from portbench import spec

_deposit = spec.load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "deposit_ref.py"))

transaction = _deposit.transaction
statement = _deposit.statement
