"""Milliseconds a proof that prove_batch waits, after its loop, for the
host workers' combines left, over every proof of the window."""


def read(run):
    if run.kind != "batch" or not run.records:
        return None
    return 1e3 * sum(rec["timings"]["drain"] for rec in run.records) / sum(
        len(rec["proofs"]) for rec in run.records)
