"""Milliseconds a proof of prove_batch's dispatching loop (each witness's
limbs, upload, QAP and MSMs on the calling thread while the host workers
combine), over every proof of the window."""


def read(run):
    if run.kind != "batch" or not run.records:
        return None
    return 1e3 * sum(rec["timings"]["dispatch"] for rec in run.records) / sum(
        len(rec["proofs"]) for rec in run.records)
