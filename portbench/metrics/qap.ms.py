"""Milliseconds of a proof's QAP witness map (Prover.timings["qap"]: its
kernels queued and run, the device synchronised), as a mean."""


def read(run):
    if run.kind != "prove" or not run.records:
        return None
    return 1e3 * sum(rec["timings"]["qap"] for rec in run.records) / len(
        run.records)
