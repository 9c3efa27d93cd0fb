"""Seconds of the service's verify call a transaction, as a mean (the host
pairing check)."""


def read(run):
    if run.kind != "tx" or not run.records:
        return None
    return sum(rec["t2"] - rec["t1"] for rec in run.records) / len(
        run.records)
