"""Pre-warm what a fresh process would otherwise pay inside its first
proof. The port has no compile cache: warming is building the kernel
library (nvcc, into blockmaze_tpu_torch/_build/) and every host library
of utils/kernels.HOST_LIBS (g++: the tokenizer, the prover's witness
limbs and its host group law), resolving every named circuit's key, so
that a fresh tree runs keygen here once (the seeded keys of
blockmaze_tpu_torch/_keys/; or --key-dir D's text keys, whose npz cache
is written beside them), and one proof a circuit at (r, s) = (1, 2),
verified.

    python -m blockmaze_tpu_torch.scripts.prewarm
        [--circuits mint,send,redeem,deposit[,deposit20]] [--key-dir D]
        [--lanes N] [--window C] [--device cuda]
"""

from __future__ import annotations

import sys
import time

from ..circuits import instances
from ..groth16 import verifier
from ..groth16.prover import Prover
from ..utils import kernels as kn
from . import _common as cm


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--circuits", default="mint,send,redeem,deposit",
                   help="comma-separated names of circuits/instances.py")
    cm.add_prover_args(p)
    args = p.parse_args(argv)
    names = [c.strip() for c in args.circuits.split(",") if c.strip()]
    unknown = [c for c in names if c not in instances.CIRCUITS]
    if unknown:
        p.error(f"unknown circuits {unknown}; known: "
                f"{sorted(instances.CIRCUITS)}")
    dev = cm.start(args)
    t0 = time.perf_counter()
    library = "none on the CPU"
    if dev.type == "cuda":
        library = kn.build()
        kn.kernel_lib()
    host = ", ".join(f"{src} {kn.host_lib(src)._name}"
                     for src in kn.HOST_LIBS)
    t_build = time.perf_counter() - t0
    cm.say(f"kernels {library}, {host}: {t_build:.1f}s")
    summary = {"metric": "prewarm", "device": str(dev),
               "build_s": t_build, "circuits": []}
    kn.reset_counts()
    for name in names:
        pb = instances.protoboard(name)
        keys = cm.resolve_keys(name, dev, args.key_dir, lambda: pb)
        prover = Prover(keys.dpk, dev, lanes=args.lanes, window=args.window)
        primary = pb.primary_input()
        proof, t = cm.wall_s(lambda: prover.prove(primary,
                                                  pb.auxiliary_input(),
                                                  r=1, s=2), dev)
        ok = verifier.verify(keys.vk, primary, proof)
        what = "keygen" if keys.source == "keygen" else "pk load"
        cm.say(f"[{name}] {what} {keys.seconds:.1f}s  first prove {t:.2f}s"
               f"  verified {ok}")
        summary["circuits"].append({"circuit": name,
                                    "key_source": keys.source,
                                    "key_s": keys.seconds, "first_s": t,
                                    "verified": ok})
        if not ok:
            cm.say(f"PREWARM FAILED: the {name} proof does not verify")
            cm.emit(summary)
            sys.exit(1)
    summary["launches"] = cm.launches()
    cm.say("PREWARM DONE")
    cm.emit(summary)


if __name__ == "__main__":
    main()
