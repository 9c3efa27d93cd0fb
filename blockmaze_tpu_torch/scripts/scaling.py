"""MSM scaling efficiency: one G1 MSM of the n synthetic points i G,
i = 1..n (cached as an npz in blockmaze_tpu_torch/_keys/), sharded over
k devices by parallel.mesh.sharded_msm: ms/MSM, Mpoints/s and the
efficiency t1 / (k tk) for each k. Every MSM is blinded as a proof's are
(one blind on every shard, taken out on the host by unblind_msm).

In one process: make_mesh(k) for each k of --devices up to the visible
cards (a larger k is skipped with a `# skip` line); with --device cpu, k
CPU shards. Across processes (--coordinator/--num-processes/--process-id,
or the variables torchrun sets): each process joins the group through
distributed.initialize and sharded_msm runs on distributed.global_mesh(),
one shard a process, beside rank 0's single-card MSM of the same points,
timed while the other ranks wait; only rank 0 prints. Every result must
equal (sum_i i k_i) G; a mismatch exits nonzero. The last line is the JAX
script's {"metric": "msm_scaling", ...} with the placement and the
backend.

    python -m blockmaze_tpu_torch.scripts.scaling [--n 262144]
        [--devices 1 2 4] [--window 13] [--reps 3] [--device cuda]
    torchrun --nproc-per-node 2 -m blockmaze_tpu_torch.scripts.scaling
    python -m blockmaze_tpu_torch.scripts.scaling --coordinator h0:29500 \\
        --num-processes 2 --process-id $RANK
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..curves import host_curve as HC
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..groth16 import keys as K
from ..msm import pippenger as pp
from ..parallel import distributed
from ..parallel import mesh as pm
from ..utils import kernels as kn
from . import _common as cm
from .msmbench import seeded_scalars, unblinded


def synthetic_points(n: int, cache: str = cm.KEY_CACHE):
    """The affine points i G, i = 1..n, as host (X, Y, inf) Montgomery
    limb arrays, from the npz cache in `cache` or built by a host chain
    of additions and cached (written whole or not at all)."""
    path = os.path.join(cache, f"synth_g1_{n}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["X"], z["Y"], z["inf"]
    G = HC.g1_generator()
    pts = [G]
    for _ in range(n - 1):
        pts.append(HC.g1_add(pts[-1], G))
    X, Y, inf = tc.g1_affine_to_device(pts)
    os.makedirs(cache, exist_ok=True)

    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, X=X, Y=Y, inf=inf)

    K.replace_atomically(path, write)
    return X, Y, inf


def points(n: int, dev):
    """synthetic_points as (X, Y, inf) tensors on dev."""
    X, Y, inf = synthetic_points(n)
    return (tf.to_tensor(X, dev), tf.to_tensor(Y, dev),
            torch.from_numpy(np.asarray(inf, dtype=bool)).to(dev))


def timed_msm(fn, devices, reps: int):
    """(fn()'s first result, ms per call of `reps` more by the host clock,
    every device synced before and after; None when reps is 0)."""
    res = fn()
    if not reps:
        return res, None
    for d in dict.fromkeys(devices):
        cm.sync(d)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    for d in dict.fromkeys(devices):
        cm.sync(d)
    return res, (time.perf_counter() - t0) * 1e3 / reps


def mesh_msm(mesh, pts, sc, c: int, lanes: int, reps: int, blind):
    """sharded_msm over `mesh` (the points placed on their shards first,
    as a Prover holds them) with blind = (R, (Rx, Ry)): (the result as a
    host point, ms/MSM of timed_msm)."""
    R, rxy = blind
    shards = mesh.shard_points(pts)
    res, ms = timed_msm(lambda: pm.sharded_msm(mesh, "g1", shards, sc, c,
                                               lanes, blind=rxy),
                        mesh.local_devices, reps)
    return unblinded("g1", res, R, c), ms


def row(k: int, ms: float, n: int, t1: float):
    """The JAX script's row of k devices, with the efficiency."""
    return {"n_dev": k, "sec_per_msm": ms / 1e3,
            "mpoints_per_sec": n / ms / 1e3, "efficiency": t1 / (k * ms)}


def scaling_rows(meshes, pts, sc, c: int, lanes: int, reps: int, blind):
    """mesh_msm over each mesh in turn: (a row per mesh, its efficiency
    against the first mesh's time times its size; the results)."""
    n = pts[0].shape[0]
    rows, results, t1 = [], [], None
    for mesh in meshes:
        got, ms = mesh_msm(mesh, pts, sc, c, lanes, reps, blind)
        t1 = t1 or ms * mesh.size
        rows.append(row(mesh.size, ms, n, t1))
        results.append(got)
    return rows, results


def process_rows(gmesh, pts, sc, c: int, lanes: int, reps: int):
    """On a ProcessMesh, with one blind that rank 0 draws: rank 0's
    single-card MSM, timed while the other ranks wait, and sharded_msm
    over the ranks. (rows for 1 and k, the results), the same on every
    rank."""
    import torch.distributed as dist
    n = pts[0].shape[0]
    R, rxy = blind = pp.make_blind("g1", gmesh.local,
                                   gmesh.broadcast(pp.blind_scalar()))
    single = t1 = None
    dist.barrier()
    if gmesh.rank == 0:
        res, t1 = timed_msm(lambda: pp.msm("g1", pts, sc, c, lanes,
                                           blind=rxy),
                            [gmesh.local], reps)
        single = unblinded("g1", res, R, c)
    dist.barrier()
    single, t1 = gmesh.broadcast((single, t1))
    got, tk = mesh_msm(gmesh, pts, sc, c, lanes, reps, blind)
    return [row(1, t1, n, t1), row(gmesh.size, tk, n, t1)], [single, got]


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--n", type=int, default=1 << 18)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4])
    p.add_argument("--window", type=int, default=13)
    p.add_argument("--lanes", type=int, default=None,
                   help="most accumulation lanes (default "
                        "pippenger.MAX_LANES on a card, 64 on the CPU)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    dev = cm.device(args.device)
    joined = distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        device=None if args.device == "cuda" else dev)
    gmesh = distributed.global_mesh() if joined else None
    dev = gmesh.local if joined else dev
    lead = not joined or gmesh.rank == 0

    def say(*a):
        if lead:
            cm.say(*a)

    if lead:
        cm.banner(dev)
    n, c = args.n, args.window
    lanes = args.lanes or (pp.MAX_LANES if dev.type == "cuda" else 64)
    t0 = time.perf_counter()
    pts, source = points(n, dev), f"synthetic i*G, i=1..{n}"
    ks, sc = seeded_scalars(n, dev, seed=11)
    say(f"# points: {source} ({time.perf_counter() - t0:.1f}s with the "
        f"scalars)")
    kn.reset_counts()
    if joined:
        rows, results = process_rows(gmesh, pts, sc, c, lanes, args.reps)
        placement, backend = [str(d) for d in gmesh.devices], gmesh.backend
    else:
        visible = (torch.cuda.device_count() if dev.type == "cuda"
                   else max(args.devices))
        meshes = []
        for k in args.devices:
            if k > visible:
                say(f"# skip n_dev={k} (only {visible} devices)")
                continue
            meshes.append(pm.make_mesh(k) if dev.type == "cuda"
                          else pm.Mesh([dev] * k))
        rows, results = scaling_rows(meshes, pts, sc, c, lanes, args.reps,
                                     pp.make_blind("g1", dev))
        placement = [str(d) for d in meshes[-1].devices] if meshes else []
        backend = dev.type
    for r in rows:
        say(f"n_dev={r['n_dev']:2d}  {r['sec_per_msm'] * 1e3:9.3f} ms/msm  "
            f"{r['mpoints_per_sec']:8.3f} Mpoints/s  efficiency "
            f"{r['efficiency'] * 100:5.1f}%")
    ref, what = HC.g1_mul(HC.g1_generator(), sum(
        (i + 1) * k for i, k in enumerate(ks)) % R_MOD), "(sum i*k_i)*G"
    ok = bool(results) and all(got == ref for got in results)
    say(f"every result equals {what}: {ok}")
    out = {"metric": "msm_scaling", "n": n, "window": c, "lanes": lanes,
           "backend": backend, "placement": placement,
           "processes": gmesh.size if joined else 1,
           "physical_cores": os.cpu_count(), "points": source,
           "rows": rows, "equal": ok, "launches": cm.launches()}
    if joined:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    if not ok:
        say("SCALING FAILED: a sharded MSM differs")
    else:
        say(f"SCALING OK: {len(rows)} rows equal {what}")
    if lead:
        cm.emit(out)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
