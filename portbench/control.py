"""The judge's readings on many seeds in one process, with the program as it
is or with a control or a fault put in its place.

    python3 -m portbench.control --workload <cell> --seeds a,b,c \
        --seconds <s> [--plant <name>]

sets the cell up once (keys, Prover or service), then for each seed makes
the seed's pool, runs a window of --seconds and prints one JSON line: the
seed, the requests, every number the judge compares and whether the run
would be correct. The benchmark's own runs never plant anything.

Controls, each breaking one guarantee that the configurations state:
- zk_off: the program's Prover with its zero-knowledge draws left out
  (r = s = 0, a path the Prover has: it takes r and s as given), so two
  proofs of one witness are equal; the judge's `blinding` must catch it;
- other_setup: the program's keys from another trusted setup (the set-up
  seed plus one), so its proofs verify under no key of the deployment;
  `key` and `rejected` must catch it.
Faults, each a way the timed path can break:
- altered: every proof the Prover returns has C moved by the generator,
  an answer altered where it is produced;
- half_batch: prove_batch proves the first half of its batch and returns
  those proofs twice, the second half left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import judge, spec
from .run import Context, cards, process_age, say, window
from . import loops


def _after_setup(loop, patch):
    setup = loop.setup

    def patched():
        setup()
        patch(_prover(loop))
    loop.setup = patched


def _prover(loop):
    return loop.circuit.prover if loop.kind == "tx" else loop.prover


def zk_off(loop):
    def patch(prover):
        prove, prove_batch = prover.prove, prover.prove_batch
        prover.prove = lambda primary, aux, r=None, s=None: prove(
            primary, aux, r=0, s=0)
        prover.prove_batch = lambda insts, rs=None, ss=None: prove_batch(
            insts, [0] * len(insts), [0] * len(insts))
    _after_setup(loop, patch)


def other_setup(loop):
    loop.ctx.setup_seed += 1


def _alter(proof):
    from blockmaze_tpu_torch.curves import host_curve as HC
    proof.c = HC.g1_add(proof.c, HC.g1_generator())
    return proof


def altered(loop):
    def patch(prover):
        prove, prove_batch = prover.prove, prover.prove_batch
        prover.prove = lambda *a, **k: _alter(prove(*a, **k))
        prover.prove_batch = lambda *a, **k: [_alter(p) for p in
                                              prove_batch(*a, **k)]
    _after_setup(loop, patch)


def half_batch(loop):
    def patch(prover):
        prove_batch = prover.prove_batch

        def half(insts, rs=None, ss=None):
            k = len(insts) // 2
            proofs = prove_batch(insts[:k], rs and rs[:k], ss and ss[:k])
            return proofs + proofs[:len(insts) - k]
        prover.prove_batch = half
    _after_setup(loop, patch)


PLANTS = {"zk_off": zk_off, "other_setup": other_setup, "altered": altered,
          "half_batch": half_batch}


def readings(root: str, workload: str, seeds, seconds: float, devices,
             plant=None):
    """Yield, for each seed, the judge's checks of a window of that seed's
    traffic on the cell's `devices`, after one set-up."""
    cell = spec.Cell(root, workload)
    ctx = Context(cell, seeds[0], devices, False)
    loop = loops.KINDS[cell.traffic["kind"]](ctx)
    if plant is not None:
        plant(loop)
    loop.setup()
    say(f"set-up {process_age():.1f} s")
    for i, seed in enumerate(seeds):
        ctx.seed = seed
        if i:
            loop.make_pool(seed)
        records, failed, window_s, _ = window(loop, seconds, False)
        checked = judge.checks(loop, records, failed, seed,
                               loop.program_key())
        yield {"seed": seed, "requests": len(records), "window_s": window_s,
               "correct": all(c["value"] <= c["limit"]
                              for c in checked.values()),
               "checks": {k: c["value"] for k, c in checked.items()}}
    loop.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--plant", choices=sorted(PLANTS), default=None)
    args = p.parse_args(argv)
    import torch
    cell = spec.Cell(os.getcwd(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s)")
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for reading in readings(os.getcwd(), args.workload, seeds, args.seconds,
                            cards(cell.chips), PLANTS.get(args.plant)):
        reading["plant"] = args.plant
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
