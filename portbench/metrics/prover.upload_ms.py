"""Milliseconds a proof spends putting its wires on the card (the span
prover.upload: the upload and the Montgomery form's launch, host side, in
the wires lap), a mean over the window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.upload"})
