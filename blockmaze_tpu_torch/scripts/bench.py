"""Benchmark: Groth16 proofs/s of each circuit on the port, the counterpart
of the JAX package's bench.py, with its JSON keys.

For each circuit, in the order given (default deposit, mint, send,
redeem: the headline circuit first):

  key       --key-dir D: D/<circ>pk.txt through keys.load_or_build (or the
            npz cache it writes beside it) and D/<circ>vk.txt, as bench.py
            reads reference_harness/prfKey/; a circuit with neither text
            key nor npz gets bench.py's error string under "errors" and
            the run goes on. Without it, the seeded keys of
            blockmaze_tpu_torch/_keys/ (keygen on a miss). Timed apart
            ({circ}_key_sec, {circ}_key_source): keygen is never inside a
            rate.
  witness   circuits/witnesses.py's function, generate_witness only, no
            constraints, as bench.py's ({circ}_witness_sec)
  Prover    its construction, which uploads the key and the QAP tables
            ({circ}_warmup_sec: the port has no Prover.warmup, whose XLA
            loads and program upload this takes the place of)
  proofs    a first proof at (r, s) = (1, 2) ({circ}_first_prove_sec),
            then REPS proofs at (3 + i, 5 + i), each timed by the host
            clock with the device synced ({circ}_prove_secs);
            {circ}_proofs_per_sec = REPS / their sum (bench.py's mean
            rate) and {circ}_proofs_per_sec_with_witness = 1 / (mean +
            witness seconds)
  verify    the port's verifier on the first proof and on every timed one,
            after the timed proofs; any rejection exits 1

Before the first circuit the device is initialised (init_sec) and the
kernel library built or loaded (build_sec, library), so no circuit's
Prover holds the device's start nor its first proof an nvcc build. The JSON line so far is
printed after every circuit; then `BENCH OK: ...` and the whole line last.
Its headline (headline()) is bench.py's: deposit, else mint, else 0.0.
Numbers are unrounded. Lanes and window default to the Prover's own (its
lanes on the card, pippenger.default_window(n)); {circ}_lanes and
{circ}_window are the values each circuit used, and the top-level lanes
and window the ones asked for (null: the Prover's default).
{circ}_vs_baseline divides by the reference's single-core prove time on
another host (BASELINE), not by anything measured on this machine.

    python -m blockmaze_tpu_torch.scripts.bench [deposit mint send redeem]
        [--reps 3] [--lanes N] [--window C] [--key-dir D] [--device cuda]

bench.py's knobs are read under its names when the flags are not given:
BMTPU_BENCH_CIRCUITS (comma-separated), BMTPU_REPS, BMTPU_LANES,
BMTPU_WINDOW.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import torch

from ..circuits.witnesses import WITNESS
from ..groth16 import keys as K
from ..groth16 import verifier
from ..groth16.prover import Prover
from ..ntt.domain import BasicDomain
from ..utils import kernels as kn
from . import _common as cm

# single-core reference prove times that bench.py divides by: libsnark on
# the JAX package's round-4 host (reference_harness/BASELINE_MEASURED.md,
# reference_harness/build/baseline_run_r4.log), not this card's host
BASELINE = {"mint": 1.0 / 11.485, "deposit": 1.0 / 28.868,
            "send": 1.0 / 14.845, "redeem": 1.0 / 8.757}
CIRCUITS = ["deposit", "mint", "send", "redeem"]
FIRST_RS = (1, 2)


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v else None


def key_error(circ: str, key_dir: str) -> str | None:
    """bench.py's error string for a circuit whose text key and npz cache
    are both absent from key_dir, else None."""
    pk_path = os.path.join(key_dir, f"{circ}pk.txt")
    cached = os.path.join(key_dir, f"{circ}pk.v{K.CACHE_VERSION}.npz")
    if os.path.exists(pk_path) or os.path.exists(cached):
        return None
    # distinguish "never generated" from "npz from an older CACHE_VERSION
    # exists but there is no pk.txt to rebuild from"
    stale = glob.glob(os.path.join(key_dir, f"{circ}pk.v*.npz"))
    if stale:
        return (f"{circ}: npz cache is stale (found {stale}, need "
                f"v{K.CACHE_VERSION}) and no pk.txt to rebuild")
    return f"{circ}: reference keys not generated"


def bench_circuit(circ: str, dev, reps: int, lanes=None, window=None,
                  key_dir=None, witness=WITNESS, cache: str = cm.KEY_CACHE):
    """Circuit `circ` benched as bench.py benches it (the module's
    docstring): its keys (cm.resolve_keys), witness[circ]() timed, the
    Prover, a first proof at FIRST_RS and `reps` timed proofs at (3 + i,
    5 + i), then every proof through the port's verifier. Returns (its
    {circ}_* fields, [first proof, *timed proofs], all verified)."""
    # a seeded-cache miss runs keygen on instances.protoboard(circ), the
    # instance with its constraints
    keys = cm.resolve_keys(circ, dev, key_dir, cache=cache)
    cm.say(f"  key ({keys.source}): {keys.seconds:.3f}s  "
           f"n={keys.dpk.num_variables} m={keys.dpk.domain_size}")
    t0 = time.perf_counter()
    pb = witness[circ]()
    wit_s = time.perf_counter() - t0
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    cm.say(f"  witness (generate_witness only): {wit_s:.3f}s")
    prover, warm_s = cm.wall_s(lambda: Prover(keys.dpk, dev, lanes=lanes,
                                              window=window), dev)
    cm.say(f"  Prover (key and tables to {dev}): {warm_s:.3f}s  "
           f"lanes={prover.lanes} window={prover.window}")
    before = kn.counts()
    first, first_s = cm.wall_s(lambda: prover.prove(primary, aux,
                                                    r=FIRST_RS[0],
                                                    s=FIRST_RS[1]), dev)
    cm.say(f"  first prove at (r, s) = {FIRST_RS}: {first_s:.4f}s")
    proofs, secs = [first], []
    for i in range(reps):
        proof, t = cm.wall_s(lambda: prover.prove(primary, aux, r=3 + i,
                                                  s=5 + i), dev)
        proofs.append(proof)
        secs.append(t)
    after = kn.counts()
    cm.say("  timed proofs: " + ", ".join(f"{t:.4f}s" for t in secs))
    t0 = time.perf_counter()
    verified = [verifier.verify(keys.vk, primary, p) for p in proofs]
    verify_s = time.perf_counter() - t0
    cm.say(f"  port verifier on {len(proofs)} proofs: {verified} "
           f"({verify_s:.3f}s)")
    mean = sum(secs) / reps
    pps = reps / sum(secs)
    f = {"key_sec": keys.seconds, "key_source": keys.source,
         "n": keys.dpk.num_variables, "m": keys.dpk.domain_size,
         "domain": ("basic" if isinstance(prover.domain, BasicDomain)
                    else "step"),
         "lanes": prover.lanes, "window": prover.window,
         "witness_sec": wit_s, "warmup_sec": warm_s,
         "first_prove_sec": first_s, "prove_secs": secs,
         "proofs_per_sec": pps,
         # the end-to-end rate with the witness (bench.py's; the
         # reference's baselines time the prove alone)
         "proofs_per_sec_with_witness": 1.0 / (mean + wit_s),
         "verified": all(verified),
         # the kernels of the 1 + reps proofs alone
         "launches": {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}}
    if circ in BASELINE:
        f["vs_baseline"] = pps / BASELINE[circ]
    return {f"{circ}_{k}": v for k, v in f.items()}, proofs, all(verified)


def headline(out: dict) -> dict:
    """bench.py's headline block on `out` (in place): deposit's proofs/s,
    else mint's, else 0.0, as value, with vs_baseline; value_e2e is the
    same circuit's rate with the witness (bench.py sets it for deposit
    alone; 0.0 when neither was benched). metric names the circuit of
    value in every branch, since the line is printed after each circuit."""
    if "deposit_proofs_per_sec" in out:
        out["metric"] = "deposit_proofs_per_sec"
        out["value"] = out["deposit_proofs_per_sec"]
        out["value_e2e"] = out["deposit_proofs_per_sec_with_witness"]
        out["vs_baseline"] = out["deposit_vs_baseline"]
    elif "mint_proofs_per_sec" in out:
        out["metric"] = "mint_proofs_per_sec"
        out["value"] = out["mint_proofs_per_sec"]
        out["value_e2e"] = out["mint_proofs_per_sec_with_witness"]
        out["vs_baseline"] = out["mint_vs_baseline"]
    else:
        out["metric"] = "deposit_proofs_per_sec"
        out["value"] = 0.0
        out["value_e2e"] = 0.0
        out["vs_baseline"] = 0.0
    return out


def run(circuits, dev, reps: int, lanes=None, window=None, key_dir=None,
        witness=WITNESS, cache: str = cm.KEY_CACHE):
    """bench_circuit over `circuits`, the JSON line so far printed after
    each. Returns (the line, the names of circuits with a rejected
    proof)."""
    out = {"metric": "deposit_proofs_per_sec", "unit": "proofs/s",
           "lanes": lanes, "window": window, "reps": reps,
           "backend": dev.type, "device": str(dev),
           "card": cm.card_line() if dev.type == "cuda" else "cpu",
           "key_dir": key_dir}
    # the device's context before the first Prover (bench.py's JAX backend
    # is up before its first circuit)
    _, out["init_sec"] = cm.wall_s(lambda: torch.zeros(1, device=dev), dev)
    t0 = time.perf_counter()
    out["library"] = "none (plain versions on the CPU)"
    if dev.type == "cuda":
        out["library"] = ("load" if os.path.exists(kn.library_path())
                          else "build")
        kn.kernel_lib()
    out["build_sec"] = time.perf_counter() - t0
    cm.say(f"device init {out['init_sec']:.2f}s, kernel library "
           f"({out['library']}): {out['build_sec']:.2f}s")
    kn.reset_counts()
    rejected = []
    for circ in circuits:
        cm.say(f"===== {circ} =====")
        err = key_error(circ, key_dir) if key_dir else None
        if err:
            cm.say(f"  {err}")
            out.setdefault("errors", []).append(err)
        else:
            fields, _, ok = bench_circuit(circ, dev, reps, lanes, window,
                                          key_dir, witness, cache)
            out.update(fields)
            if not ok:
                rejected.append(circ)
        out["launches"] = cm.launches()
        cm.emit(headline(out))
    return out, rejected


def arguments(argv=None):
    """The parsed flags, bench.py's environment knobs their defaults;
    refuses a circuit bench.py does not bench and --reps below 1."""
    p = cm.parser(__doc__)
    env = os.environ.get("BMTPU_BENCH_CIRCUITS")
    p.add_argument("circuits", nargs="*",
                   default=([c.strip() for c in env.split(",") if c.strip()]
                            if env else CIRCUITS),
                   help=f"of {CIRCUITS} (default BMTPU_BENCH_CIRCUITS, "
                        f"else all four, deposit first)")
    p.add_argument("--reps", type=int, default=_env_int("BMTPU_REPS") or 3,
                   help="timed proofs a circuit (BMTPU_REPS, else 3)")
    cm.add_prover_args(p)
    p.set_defaults(lanes=_env_int("BMTPU_LANES"),
                   window=_env_int("BMTPU_WINDOW"))
    args = p.parse_args(argv)
    unknown = [c for c in args.circuits if c not in CIRCUITS]
    if unknown:
        p.error(f"unknown circuits {unknown}; bench.py's are {CIRCUITS}")
    if args.reps < 1:
        p.error("--reps must be at least 1")
    return args


def main(argv=None):
    args = arguments(argv)
    dev = cm.start(args)
    out, rejected = run(args.circuits, dev, args.reps, args.lanes,
                        args.window, args.key_dir)
    benched = [c for c in args.circuits if f"{c}_proofs_per_sec" in out]
    if rejected or not benched:
        why = (f"proofs of {rejected} rejected by the verifier" if rejected
               else f"no circuit benched ({out.get('errors')})")
        cm.say(f"BENCH FAILED: {why}")
        cm.emit(out)
        sys.exit(1)
    rates = ", ".join(f"{c} {out[f'{c}_proofs_per_sec']:.2f}" for c in benched)
    skipped = f"; errors: {out['errors']}" if "errors" in out else ""
    cm.say(f"BENCH OK: {len(benched)} circuits, every proof verified; "
           f"proofs/s {rates}{skipped}")
    cm.emit(out)


if __name__ == "__main__":
    main()
