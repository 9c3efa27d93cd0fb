"""Whether what the timed path produced is correct, by the plain reference.

Every number compared is a count with the limit 0:

- failed: requests that raised;
- key: parts of the program's key (its proving key's constants, its
  verification key) that differ from the deployment's, which the
  reference works out from the set-up seed and the stated input
  commitments;
- statement: public inputs of the program's witnesses (or, through the
  service, of its answers) that differ from the statement the reference
  works out from the transaction's plain data;
- rejected: proofs of a sample drawn from the seed (every transaction's,
  through the service) that the reference's pairing check rejects for the
  transaction's own statement;
- blinding: proofs whose A and B are not the warm-up's proof of the same
  witness moved by (r - r0) delta and (s - s0) delta, the draws the
  requests gave (every proof; not through the service, which draws its
  own);
- verdict: transactions on which the service's verifier and the
  reference disagree.
"""

from __future__ import annotations

from .loops import stream
from .reference import groth16 as G

# proofs the pairing check samples from a window (with its first and last)
SAMPLE = 24


def checks(loop, records, failed: int, seed: int, program_key: dict) -> dict:
    """{name: {"value", "limit"}} of the window's records; loop's
    program state is freed, program_key taken from it before."""
    ctx = loop.ctx
    key = G.deployment_key(ctx.config["setup_seed"], ctx.config["vk_ic"])
    out = {"failed": failed,
           "key": len(G.key_differences(key, program_key))}
    if loop.kind == "tx":
        out.update(_tx(ctx, key, records))
    else:
        out.update(_proofs(ctx, key, loop, records, seed))
    return {k: {"value": v, "limit": 0} for k, v in out.items()}


def _proofs(ctx, key, loop, records, seed):
    statements = [ctx.ref.statement(tx, ctx.config) for tx in loop.txs]
    mismatched = sum(p != s for p, s in zip(loop.primaries(), statements))
    proofs = loop.proofs(records)
    n = len(proofs)
    sample = set(stream(seed, "sample").sample(range(n), min(n, SAMPLE)))
    sample |= {0, n - 1} if n else set()
    rejected = sum(not G.verify(key, statements[proofs[i][0]], proofs[i][3])
                   for i in sorted(sample))
    moved = 0
    for slot, r, s, proof in proofs:
        r0, s0, p0 = loop.base[slot]
        moved += not G.blinded_as_drawn(key, p0, r0, s0, proof, r, s)
    return {"statement": mismatched, "rejected": rejected, "blinding": moved}


def _tx(ctx, key, records):
    mismatched = rejected = disagree = 0
    for rec in records:
        statement = ctx.ref.statement(rec["tx"], ctx.config)
        mismatched += list(rec["primary"]) != statement
        try:
            ok = G.verify(key, statement, G.proof_from_wire(rec["proof_hex"]))
        except ValueError:
            ok = False
        rejected += not ok
        disagree += bool(rec["verdict"]) != ok
    return {"statement": mismatched, "rejected": rejected,
            "verdict": disagree}
