"""Deposit at Merkle depth 20 end to end on the port's own trusted setup:
the witness, the keys (the seeded keygen, cached as deposit20 in
blockmaze_tpu_torch/_keys/; or --key-dir D's deposit20pk.txt and
deposit20vk.txt), timed apart, a first proof at (1, 2), --reps more at
random (r, s), and the port's verifier, then the reference's where it is
built (as e2e).

Depth 20 is the production Merkle depth (the reference's VNT.h keeps 8
for its tests); the reference ships no depth-20 keys, so this runs the
port's own setup at a 2^20 domain.

    python -m blockmaze_tpu_torch.scripts.depth20 [--reps 2] [--lanes N]
        [--window C] [--key-dir D] [--device cuda]
"""

from __future__ import annotations

import sys
import time

from ..circuits import instances
from ..utils import kernels as kn
from . import _common as cm
from .e2e import prove_and_verify

NAME = "deposit20"


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--reps", type=int, default=2)
    cm.add_prover_args(p)
    args = p.parse_args(argv)
    dev = cm.start(args)
    t0 = time.perf_counter()
    pb = instances.protoboard(NAME)
    t_wit = time.perf_counter() - t0
    cm.say(f"witness (depth 20): {t_wit:.1f}s  constraints="
           f"{len(pb.constraints)}")
    keys = cm.resolve_keys(NAME, dev, args.key_dir, lambda: pb)
    what = "KEYGEN (own stack) and cache" if keys.source == "keygen" \
        else f"keys loaded ({keys.source})"
    cm.say(f"{what}: {keys.seconds:.1f}s")
    kn.reset_counts()
    row, _ = prove_and_verify(NAME, pb, keys, dev, 1 + args.reps, args.lanes,
                              args.window, rs=(1, 2))
    row.update(metric="depth20", device=str(dev), witness_s=t_wit,
               key_source=keys.source, key_s=keys.seconds,
               launches=cm.launches())
    if not row["verified"] or row["oracle"] is False:
        cm.say("DEPTH20 FAILED: the proof was rejected")
        cm.emit(row)
        sys.exit(1)
    best = min(row["repeat_s"] or [row["first_s"]])
    row["best_s"] = best
    cm.say(f"DEPTH20 OK: {best:.4f} s/proof = {1 / best:.2f} proofs/s"
           + ("" if row["oracle"] else " (port verifier only; reference "
              "oracle unavailable)"))
    cm.emit(row)


if __name__ == "__main__":
    main()
