"""End to end, named circuits: prove on the port, verify with the port's
pairing verifier and, where it is built, with the reference's unmodified
verifier (reference_harness/build/oracle*, which build_reference.sh
compiles from the reference's sources; without it the run says so and
claims only the port's verifier).

For each circuit: the key (--key-dir, or the seeded cache), n and m, the
witness's seconds, a first proof at (r, s) = (12345, 67890), --repeat - 1
more at random (r, s), each timed, and the verifiers on the last proof.
The JSON summary so far is printed after every circuit.

    python -m blockmaze_tpu_torch.scripts.e2e [mint send redeem deposit]
        [--repeat 1] [--lanes N] [--window C] [--key-dir D] [--device cuda]
"""

from __future__ import annotations

import sys
import time

from ..circuits import instances
from ..groth16 import verifier
from ..groth16.prover import Prover
from ..utils import kernels as kn
from . import _common as cm

FIRST_RS = (12345, 67890)


def prove_and_verify(name: str, pb, keys: cm.Keys, dev, repeat: int = 1,
                     lanes=None, window=None, rs=FIRST_RS):
    """Circuit `name`'s witness `pb` proved with `keys` on dev: a first
    proof at rs, repeat - 1 more at random (r, s), the last one through
    the port's verifier and the reference's (when built). Returns (the
    circuit's summary row, the first proof)."""
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    prover = Prover(keys.dpk, dev, lanes=lanes, window=window)
    first, t = cm.wall_s(lambda: prover.prove(primary, aux, r=rs[0],
                                              s=rs[1]), dev)
    cm.say(f"  prove (first, at (r, s) = {rs}): {t:.3f}s")
    row = {"circuit": name, "n": keys.dpk.num_variables,
           "m": keys.dpk.domain_size, "first_s": t, "repeat_s": []}
    proof = first
    for _ in range(repeat - 1):
        proof, t = cm.wall_s(lambda: prover.prove(primary, aux), dev)
        row["repeat_s"].append(t)
        cm.say(f"  prove repeat: {t:.3f}s")
    t0 = time.perf_counter()
    row["verified"] = verifier.verify(keys.vk, primary, proof)
    cm.say(f"  port verifier: {row['verified']} "
           f"({time.perf_counter() - t0:.3f}s)")
    oracle = cm.oracle_verify(name, keys.vk_path, proof, primary)
    if oracle is None:
        cm.say("  reference oracle: unavailable")
        row["oracle"] = None
    else:
        row["oracle"] = oracle[0]
        cm.say(f"  reference oracle: {oracle[1]}")
    return row, first


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("circuits", nargs="*",
                   default=["mint", "send", "redeem", "deposit"],
                   help=f"of {sorted(instances.CIRCUITS)}")
    p.add_argument("--repeat", type=int, default=1)
    cm.add_prover_args(p)
    args = p.parse_args(argv)
    unknown = [c for c in args.circuits if c not in instances.CIRCUITS]
    if unknown:
        p.error(f"unknown circuits {unknown}")
    dev = cm.start(args)
    summary = {"metric": "e2e", "device": str(dev), "circuits": []}
    failures = []
    kn.reset_counts()
    for name in args.circuits:
        cm.say(f"===== {name} =====")
        t0 = time.perf_counter()
        pb = instances.protoboard(name)
        t_wit = time.perf_counter() - t0
        keys = cm.resolve_keys(name, dev, args.key_dir, lambda: pb)
        cm.say(f"  key ({keys.source}): {keys.seconds:.1f}s  "
               f"n={keys.dpk.num_variables} m={keys.dpk.domain_size}")
        cm.say(f"  witness: {t_wit:.2f}s")
        row, _ = prove_and_verify(name, pb, keys, dev, args.repeat,
                                  args.lanes, args.window)
        row.update(key_source=keys.source, key_s=keys.seconds,
                   witness_s=t_wit)
        summary["circuits"].append(row)
        summary["launches"] = cm.launches()
        if not row["verified"] or row["oracle"] is False:
            failures.append(name)
        cm.emit(summary)
    if failures:
        cm.say("E2E FAILED:", ", ".join(failures))
        sys.exit(1)
    rows = summary["circuits"]
    if all(r["oracle"] for r in rows):
        how = "and verify under the unmodified reference verifier"
    else:
        how = ("and verify under the port's verifier only (reference "
               "oracle unavailable)")
    cm.say(f"E2E OK: {len(rows)}/{len(rows)} circuits prove on the port "
           f"{how}")
    cm.emit(summary)


if __name__ == "__main__":
    main()
