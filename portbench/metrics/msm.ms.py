"""Milliseconds of a proof's five MSMs (Prover.timings["msm"]: the live
streams, the accumulation, reduction and fold, the device synchronised),
as a mean."""


def read(run):
    if run.kind != "prove" or not run.records:
        return None
    return 1e3 * sum(rec["timings"]["msm"] for rec in run.records) / len(
        run.records)
