"""The 90th percentile of every proof's latency in the window: from the
call into the Prover to its return with the proof's points on the host."""

import statistics


def read(run):
    if run.kind != "prove" or len(run.records) < 2:
        return None
    lat = [rec["t1"] - rec["t0"] for rec in run.records]
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
