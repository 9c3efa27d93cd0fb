"""Milliseconds a proof of prove_batch's dispatching thread waits for the
card (the spans device.wait and prover.fetch inside prover.dispatch: the
MSMs' live counts, their results to the host, the closing synchronise),
over every proof of the window."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "batch", {"device.wait",
                                               "prover.fetch"},
                                within="prover.dispatch")
