"""Millions of live items a proof's MSMs accumulate (the info "live" of the
spans msm.query inside prover.msm, msm/pippenger.py msm, summed a proof),
a mean over the window's proofs; None where the program records no
msm.query."""

from portbench import spantree


def read(run):
    tree = spantree.tree_of(run, "prove")
    if tree is None:
        return None
    live = [s.info["live"] for s in tree.spans if s.name == "msm.query"
            and tree.has_ancestor(s, "prover.msm")]
    n = tree.count("prover.prove")
    return sum(live) / n / 1e6 if live and n else None
