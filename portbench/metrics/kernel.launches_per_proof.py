"""Hand-written kernel launches a proof (the Kernel.launches counts' rise
over the window, utils/kernels.py, over the window's prover.prove
requests)."""

from portbench import spantree


def read(run):
    tree = spantree.tree_of(run, "prove")
    launches = getattr(run, "launches", None)
    if tree is None or launches is None:
        return None
    n = tree.count("prover.prove")
    return sum(launches.values()) / n if n else None
