"""Batched proving throughput: Prover.prove_batch of B distinct witnesses
of one circuit on a real-sized key, every proof verified.

The witnesses vary per slot (values and randomness, batch_instance). The
first batch runs at r = 1..B, s = 51..50+B; --reps more batches at random
(r, s) are timed and printed as s/proof and proofs/s beside B times the
steady single proof of the same run. prove_batch runs each proof's host
combine on the Prover's combine thread, which the first batch starts.

    python -m blockmaze_tpu_torch.scripts.batch [--circuit mint|deposit]
        [--batch 8] [--reps 2] [--lanes N] [--key-dir D] [--device cuda]
"""

from __future__ import annotations

import statistics
import time

from ..circuits.deposit import DepositGadget
from ..circuits.mint import MintGadget
from ..crypto import notes as NT
from ..groth16 import verifier
from ..groth16.prover import Prover
from ..merkle import incremental as MK
from ..r1cs.protoboard import Protoboard
from ..utils import kernels as kn
from . import _common as cm


def batch_instance(name: str, i: int):
    """Witness i of a batch of `name` (mint, or deposit at depth 8): values
    and randomness varied per slot as scripts/batch.py varies mint's; the
    witness alone, as the service synthesises it. (primary, aux)."""
    sk = NT.uint256_from_hex("1")
    r_old = NT.uint256_from_hex(f"{123456 + i:x}")
    r = NT.uint256_from_hex(f"{123 + i:x}")
    pb = Protoboard()
    if name == "mint":
        note_old = NT.Note(6 + i, NT.compute_prf(sk, r_old), r_old)
        note = NT.Note(13 + i, NT.compute_prf(sk, r), r)
        MintGadget(pb).generate_witness(note_old, note, note_old.cm(),
                                        note.cm(), 7, sk)
    else:
        r_s = NT.uint256_from_hex(f"{789 + i:x}")
        pk_recv = int("123", 16).to_bytes(20, "little")
        note_old = NT.Note(255 + i, NT.compute_prf(sk, r_old), r_old)
        note_s = NT.NoteS(9, pk_recv, r_s, NT.uint256_from_hex("123"))
        note = NT.Note(264 + i, NT.compute_prf(sk, r), r)
        tree = MK.IncrementalMerkleTree(MK.DEPTH)
        wit = None
        for k in range(16):
            leaf = note_s.cm() if k == 9 else NT.uint256_from_hex(
                f"{k + 1 + 16 * i:x}")
            if wit is not None:
                wit.append(leaf)
            else:
                tree.append(leaf)
            if k == 9:
                wit = tree.witness()
        DepositGadget(pb, depth=MK.DEPTH).generate_witness(
            note_s, note_old, note, note_s.cm(), note_old.cm(), note.cm(),
            wit.root(), wit.path(), NT.compute_prf(sk, r_s), sk)
    return pb.primary_input(), pb.auxiliary_input()


def prove_batches(prover, vk, insts, rs, ss, reps: int, dev):
    """prove_batch of insts at (rs, ss), then `reps` more at random (r, s),
    each timed and every proof verified. Returns (the batches' seconds,
    the first batch's proofs); raises if a proof is rejected."""
    def run(*rs_ss):
        proofs, t = cm.wall_s(lambda: prover.prove_batch(insts, *rs_ss), dev)
        if not all(verifier.verify(vk, primary, pf)
                   for (primary, _), pf in zip(insts, proofs)):
            raise AssertionError("a batch proof does not verify")
        return proofs, t

    first, t = run(rs, ss)
    cm.say(f"prove_batch (first, at r = {rs[0]}.., s = {ss[0]}..; starts "
           f"the combine thread): {t:.3f}s; every proof verified")
    times = [t]
    for _ in range(reps):
        _, t = run(None, None)
        times.append(t)
        cm.say(f"prove_batch repeat: {t:.3f}s ({t / len(insts):.4f} "
               f"s/proof); every proof verified")
    return times, first


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--circuit", choices=["mint", "deposit"], default="mint")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=2)
    cm.add_prover_args(p)
    args = p.parse_args(argv)
    dev = cm.start(args)
    name, B = args.circuit, args.batch
    keys = cm.resolve_keys(name, dev, args.key_dir)
    cm.say(f"key ({keys.source}): {keys.seconds:.1f}s")
    t0 = time.perf_counter()
    insts = [batch_instance(name, i) for i in range(B)]
    cm.say(f"witnesses x{B}: {time.perf_counter() - t0:.1f}s")
    prover = Prover(keys.dpk, dev, lanes=args.lanes, window=args.window)
    try:
        prover.prove(*insts[0])
        single = [cm.wall_s(lambda: prover.prove(*inst), dev)[1]
                  for inst in insts[:3]]
        one = statistics.median(single)
        cm.say(f"steady single proof: {one:.4f}s ({1 / one:.2f} proofs/s)")
        kn.reset_counts()
        times, _ = prove_batches(prover, keys.vk, insts,
                                 list(range(1, B + 1)),
                                 list(range(51, 51 + B)), args.reps, dev)
        counts = cm.launches()
    finally:
        prover.close()
    best = min(times[1:] or times)
    summary = {"metric": "batch", "circuit": name, "batch": B,
               "device": str(dev), "key_source": keys.source,
               "single_s": one, "batch_s": times, "best_s": best,
               "s_per_proof": best / B, "proofs_per_s": B / best,
               "B_x_single_s": B * one, "launches": counts}
    cm.say(f"BATCH OK: batch={B} {best:.3f}s = {best / B:.4f} s/proof = "
           f"{B / best:.2f} proofs/s (B x the steady single proof "
           f"{B * one:.3f}s = {1 / one:.2f} proofs/s); all verified")
    cm.emit(summary)


if __name__ == "__main__":
    main()
