"""Milliseconds a proof's MSMs spend making their live streams (the spans
msm.stream inside prover.msm: digits, window keys, the partition with its
live count and the sort, msm/pippenger.py msm), a mean over the window's
proofs; None where the program records no msm.stream."""

from portbench import spantree


def read(run):
    tree = spantree.tree_of(run, "prove")
    if tree is None or not tree.count("msm.stream"):
        return None
    return spantree.per_request(run, "prove", {"msm.stream"},
                                within="prover.msm")
