"""Proofs completed in the window over the window's seconds (first call to
last return)."""


def read(run):
    if run.kind == "prove":
        n = len(run.records)
    elif run.kind == "batch":
        n = sum(len(rec["proofs"]) for rec in run.records)
    else:
        return None
    return n / run.window_s if n else None
