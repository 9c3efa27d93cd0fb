"""Seconds a transaction spends in the service's proof call outside its
Prover (synthesis of the witness, the proof's encoding), as a mean: the
host clock around gen_mint_proof less the Prover's own laps."""


def read(run):
    if run.kind != "tx" or not run.records:
        return None
    return sum(rec["t1"] - rec["t0"] - sum(rec["timings"].values())
               for rec in run.records) / len(run.records)
