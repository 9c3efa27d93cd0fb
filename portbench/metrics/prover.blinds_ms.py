"""Milliseconds a proof spends drawing its G1 and G2 MSM blinds on the
host (the span prover.blinds: two make_blind, in the wires lap), a mean
over the window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.blinds"})
