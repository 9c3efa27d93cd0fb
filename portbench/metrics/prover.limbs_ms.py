"""Milliseconds a proof spends turning its witness into limbs (the span
prover.limbs, in Prover.prove's wires lap), a mean over the window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.limbs"})
