"""Fresh-process warm start: where does a new process's first proof go?

Laps, each with its seconds, for one circuit in a fresh process:

  backend init    import torch, the device check, torch.cuda.init and a
                  first allocation
  kernel library  kernels.kernel_lib(): "build" when _build/ holds no
                  library of the current sources (nvcc), else "load"
  pk load         the text key or its npz (--key-dir), or the seeded
                  cache (keygen on a miss)
  Prover init     key upload, QAP tables
  witness build   the circuit's constraints and witness
  FIRST prove, second prove, third prove, TOTAL

The port has no compile cache to warm: the kernels are built once into
_build/. Run it in a fresh process per circuit:

    python -m blockmaze_tpu_torch.scripts.warmstart mint [--device cuda]
"""

from __future__ import annotations

import os
import time


def main(argv=None):
    t_start = time.perf_counter()
    mark = [t_start]
    laps = {}

    def lap(label, note=""):
        now = time.perf_counter()
        laps[label] = now - mark[0]
        print(f"[warmstart] {label}{note}: {laps[label]:.2f}s  "
              f"(t+{now - t_start:.1f}s)", flush=True)
        mark[0] = now

    import torch

    from . import _common as cm
    p = cm.parser(__doc__)
    p.add_argument("circuit", nargs="?", default="mint",
                   choices=["mint", "send", "redeem", "deposit",
                            "deposit20"])
    cm.add_prover_args(p)
    args = p.parse_args(argv)
    dev = cm.start(args)
    if dev.type == "cuda":
        torch.cuda.init()
    torch.zeros(1, device=dev)
    cm.sync(dev)
    lap("backend init")

    from ..circuits import instances
    from ..groth16 import verifier
    from ..groth16.prover import Prover
    from ..utils import kernels as kn
    library = "none (plain versions on the CPU)"
    if dev.type == "cuda":
        library = "load" if os.path.exists(kn.library_path()) else "build"
        kn.kernel_lib()
    lap("kernel library", f" ({library})")

    keys = cm.resolve_keys(args.circuit, dev, args.key_dir)
    lap("pk load", f" ({keys.source})")

    prover = Prover(keys.dpk, dev, lanes=args.lanes, window=args.window)
    cm.sync(dev)
    lap("Prover init")

    pb = instances.protoboard(args.circuit)
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    lap("witness build")

    kn.reset_counts()
    for label, (r, s) in (("FIRST prove", (1, 2)), ("second prove", (3, 5)),
                          ("third prove", (4, 6))):
        proof = prover.prove(primary, aux, r=r, s=s)
        lap(label)
    total = time.perf_counter() - t_start
    print(f"[warmstart] TOTAL: {total:.1f}s", flush=True)
    ok = verifier.verify(keys.vk, primary, proof)
    cm.say(f"third proof verified: {ok}")
    summary = {"metric": "warmstart", "circuit": args.circuit,
               "device": str(dev), "library": library,
               "key_source": keys.source, "laps_s": laps, "total_s": total,
               "launches": cm.launches(), "verified": ok}
    if not ok:
        cm.say("WARMSTART FAILED: the proof does not verify")
        cm.emit(summary)
        raise SystemExit(1)
    cm.say(f"WARMSTART OK: {args.circuit} first prove "
           f"{laps['FIRST prove']:.2f}s, total {total:.1f}s")
    cm.emit(summary)


if __name__ == "__main__":
    main()
