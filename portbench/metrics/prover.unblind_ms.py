"""Milliseconds a proof spends taking its five MSM results to affine and
their blinds out on the host (the span prover.unblind, in the combine
lap), a mean over the window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.unblind"})
