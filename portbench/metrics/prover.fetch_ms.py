"""Milliseconds a proof waits for its five MSMs' results to reach the host
(the span prover.fetch, in the combine lap), a mean over the window's
proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.fetch"})
