"""Milliseconds a proof spends in the interpreter's garbage collector (the
spans host.gc inside prover.prove requests), a mean over the window's
proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"host.gc"})
