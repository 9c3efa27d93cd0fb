"""Milliseconds a proof spends putting A, B and C together with r and s on
the host (the span prover.group, in the combine lap), a mean over the
window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"prover.group"})
