"""Items in the longest accumulation lane of a proof's MSMs (the largest
info "per_lane" of the spans msm.query inside prover.msm, msm/pippenger.py
msm: msm_round's serial chain), a mean over the window's proofs; None
where the program records no msm.query."""

from portbench import spantree


def read(run):
    tree = spantree.tree_of(run, "prove")
    if tree is None:
        return None
    most = {}
    for s in tree.spans:
        if s.name == "msm.query" and tree.has_ancestor(s, "prover.msm"):
            most[s.root] = max(most.get(s.root, 0), s.info["per_lane"])
    return sum(most.values()) / len(most) if most else None
