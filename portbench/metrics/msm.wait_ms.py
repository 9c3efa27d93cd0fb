"""Milliseconds a proof's MSM lap waits for the card (the spans device.wait
inside prover.msm: each MSM's live count and the lap's closing
synchronise), a mean over the window's proofs."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "prove", {"device.wait"},
                                within="prover.msm")
