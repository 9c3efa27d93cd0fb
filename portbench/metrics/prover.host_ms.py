"""Milliseconds a proof spends in the Prover's host stages, wires (the
witness to limbs and up to the card) and combine (the MSMs' results back,
unblinded, and A, B, C put together with r and s), as a mean over the
window's proofs (Prover.timings)."""


def read(run):
    if run.kind != "prove" or not run.records:
        return None
    return 1e3 * sum(rec["timings"]["wires"] + rec["timings"]["combine"]
                     for rec in run.records) / len(run.records)
