"""Milliseconds a proof of prove_batch spends turning its witness into
limbs on the dispatching thread (the spans prover.limbs inside
prover.dispatch), over every proof of the window."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "batch", {"prover.limbs"},
                                within="prover.dispatch")
