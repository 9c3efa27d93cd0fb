"""MSM microbenchmark: one Pippenger MSM of the port at a prover's size
(deposit's A query is 2^19 G1 points), its best time and Mpoints/s; with
--phases the split of the same MSM by the steps of msm/pippenger.py's
msm_stream, each timed on the device's clock:

  live_stream  digits, the live items' partition and their sort by key
  accumulate   the lane cut and msm_round (bucket accumulation)
  combine      boundary_partials and msm_combine (the lanes' partial sums
               into their buckets), the blind's window counts
  triangle     msm_triangle (each window's weighted bucket sum)
  fold         msm_fold (Horner over the windows)

and their sum beside the whole msm. Every MSM is blinded as a proof's
are (pippenger.make_blind; the exception-free accumulation the Prover
runs), and its blind is taken out on the host (unblind_msm). The points
tile the first 64 multiples of G and the scalars are seeded 31-byte
integers k_i, so the result must be (sum_i k_i ((i mod 64) + 1) mod r) G;
a mismatch exits nonzero.

    python -m blockmaze_tpu_torch.scripts.msmbench [--n 19] [--curve g1]
        [--window 13] [--lanes 65536] [--reps 3] [--phases] [--device cuda]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..curves import host_curve as HC
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..msm import pippenger as pp
from ..utils import kernels as kn
from . import _common as cm

BASE = 64        # distinct points, tiled


def synth_points(n: int, curve: str, dev):
    """n affine points on dev: point i is ((i mod 64) + 1) G."""
    if curve == "g1":
        G, add, conv = HC.g1_generator(), HC.g1_add, tc.g1_affine_to_device
    else:
        G, add, conv = HC.g2_generator(), HC.g2_add, tc.g2_affine_to_device
    pts = [G]
    for _ in range(BASE - 1):
        pts.append(add(pts[-1], G))
    x, y, inf = conv(pts)
    reps = -(-n // BASE)

    def tile(a):
        return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n]

    return (tf.to_tensor(tile(x), dev), tf.to_tensor(tile(y), dev),
            torch.from_numpy(tile(inf)).to(dev))


def seeded_scalars(n: int, dev, seed: int = 5):
    """(n Python ints of 31 random bytes, their (n, 16) limb tensor on
    dev); every one is below r."""
    raw = np.random.RandomState(seed).bytes(31 * n)
    ks = [int.from_bytes(raw[31 * i:31 * i + 31], "little")
          for i in range(n)]
    return ks, tf.to_tensor(tf.ints_to_limbs(ks), dev)


def inputs(n: int, curve: str, dev):
    """The benchmark's inputs: (synth_points, seeded_scalars' ints and
    limbs, a fresh blind (R, (Rx, Ry)) of pippenger.make_blind)."""
    pts = synth_points(n, curve, dev)
    ks, sc = seeded_scalars(n, dev)
    return pts, ks, sc, pp.make_blind(curve, dev)


def closed_form(curve: str, ks):
    """(sum_i k_i ((i mod 64) + 1) mod r) G, the MSM of synth_points."""
    k = sum(ki * (i % BASE + 1) for i, ki in enumerate(ks)) % R_MOD
    return (HC.g1_mul(HC.g1_generator(), k) if curve == "g1"
            else HC.g2_mul(HC.g2_generator(), k))


def to_host(curve: str, res):
    """An MSM's Jacobian (X, Y, Z) as a host affine point."""
    conv = tc.g1_jacobian_to_host if curve == "g1" else tc.g2_jacobian_to_host
    return conv(tuple(v[None] for v in res[:3]))[0]


def unblinded(curve: str, res, R, c: int):
    """A blinded MSM's (X, Y, Z, window counts) as a host affine point,
    less the blind R's surplus, as the Prover takes it out."""
    return pp.unblind_msm(curve, to_host(curve, res), res[3].cpu().numpy(),
                          R, c)


def bench(curve: str, pts, sc, c: int, lanes: int, reps: int, dev, blind):
    """pippenger.msm `reps` times with blind = (R, (Rx, Ry)) (make_blind):
    (its result as a host point, the ms of each run on the device's
    clock)."""
    R, rxy = blind
    times = []
    for _ in range(reps):
        laps = cm.Laps(dev)
        laps.mark()
        res = pp.msm(curve, pts, sc, c, lanes, blind=rxy)
        laps.mark("msm")
        times.append(laps.ms()["msm"])
    return unblinded(curve, res, R, c), times


def phase_split(curve: str, pts, sc, c: int, lanes: int, reps: int, dev,
                blind):
    """pippenger.msm's steps timed apart, `reps` times: live_stream, then
    msm_stream with a lap at each of its steps. (The result as a host
    point, the ms of each step in the run of least total.)"""
    R, rxy = blind
    best = None
    for _ in range(reps):
        laps = cm.Laps(dev)
        laps.mark()
        stream = pp.live_stream(pts, sc, c)
        laps.mark("live_stream")
        res = pp.msm_stream(curve, pts, stream, c, lanes, rxy,
                            step=laps.mark)
        ms = laps.ms()
        if best is None or sum(ms.values()) < sum(best.values()):
            best = ms
    return unblinded(curve, res, R, c), best


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--n", type=int, default=19, help="log2 point count")
    p.add_argument("--curve", choices=["g1", "g2"], default="g1")
    p.add_argument("--window", type=int, default=13)
    p.add_argument("--lanes", type=int, default=None,
                   help=f"most accumulation lanes (default "
                        f"pippenger.MAX_LANES = {pp.MAX_LANES})")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--phases", action="store_true",
                   help="time the MSM's steps separately")
    args = p.parse_args(argv)
    dev = cm.start(args)
    n, curve, c = 1 << args.n, args.curve, args.window
    lanes = args.lanes or pp.MAX_LANES
    t0 = time.perf_counter()
    pts, ks, sc, blind = inputs(n, curve, dev)
    want = closed_form(curve, ks)
    cm.say(f"inputs: {time.perf_counter() - t0:.1f}s")
    kn.reset_counts()
    res, times = bench(curve, pts, sc, c, lanes, 1 + args.reps, dev, blind)
    best = min(times[1:])
    cm.say(f"msm {curve} n=2^{args.n} c={c} lanes={lanes}: first "
           f"{times[0]:.3f}ms  best {best:.3f}ms  {n / best / 1e3:.2f} "
           f"Mpoints/s")
    summary = {"metric": "msm", "curve": curve, "log_n": args.n, "window": c,
               "lanes": lanes, "device": str(dev), "first_ms": times[0],
               "ms": times[1:], "best_ms": best,
               "mpoints_per_s": n / best / 1e3}
    ok = res == want
    if args.phases:
        split, phases = phase_split(curve, pts, sc, c, lanes, args.reps, dev,
                                    blind)
        for k, ms in phases.items():
            cm.say(f"  {k:<12} {ms:9.3f}ms")
        total = sum(phases.values())
        cm.say(f"  phases sum {total:.3f}ms  (whole msm best {best:.3f}ms)")
        summary.update(phases_ms=phases, phases_sum_ms=total)
        ok = ok and split == want
    summary["launches"] = cm.launches()
    summary["closed_form"] = ok
    cm.say(f"equals (sum_i k_i ((i mod 64) + 1)) G: {ok}")
    if not ok:
        cm.say("MSMBENCH FAILED: the MSM differs from its closed form")
        cm.emit(summary)
        sys.exit(1)
    cm.say(f"MSMBENCH OK: {curve} 2^{args.n} {n / best / 1e3:.2f} Mpoints/s")
    cm.emit(summary)


if __name__ == "__main__":
    main()
