"""Smoke run of the PyTorch/CUDA port (blockmaze_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each timed; any failure raises and the script exits nonzero:
  0. build the CUDA kernels from blockmaze_tpu_torch/csrc (nvcc, sm_90a);
  1. every kernel against its plain torch version on the same CUDA tensors,
     bit-exact, with kernel and plain times;
  2. MSMs at the prover's sizes against closed forms: sum_i k_i * (i*G)
     = (sum_i i*k_i mod r) * G for 2^18 G1 points and 2^14 G2 points;
  3. the mint circuit end to end: constraints and witness, keygen (seeded
     toxic waste), Prover on cuda:0, three proofs, each verified by the host
     verifier, and two proofs with equal (r, s) equal.
The launch counts of every kernel are reset just before phase 3 and must
all be nonzero after it. The second-to-last line is the kernel table as
JSON; the last line is the result JSON. With no GPU it exits nonzero before
printing either.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016


def log(*a):
    print(*a, flush=True)


def require_gpu():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script only runs on a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "blockmaze_tpu_torch", "csrc")):
        sys.exit("chip_smoke: blockmaze_tpu_torch/csrc not found next to "
                 "this script; run it from a checkout of the repository")
    sys.path.insert(0, here)


def timed(fn, reps: int = 5) -> float:
    """Milliseconds per call of fn on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    require_gpu()
    from blockmaze_tpu_torch.utils import kernels as kn

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        and smi.stdout.strip() else "nvidia-smi: unavailable")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    rng = np.random.default_rng(SEED)
    report = {name: {"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces}
              for name, k in kn.K.items()}
    t_all = time.perf_counter()

    # ---- phase 0: build --------------------------------------------------
    t0 = time.perf_counter()
    lib = kn.build(verbose=True)
    kn.LIB.get()
    log(f"phase 0 build: {time.perf_counter() - t0:.1f}s ({lib})")

    # ---- phase 1: parity -------------------------------------------------
    t0 = time.perf_counter()
    phase1(dev, rng, report)
    log(f"phase 1 parity: {time.perf_counter() - t0:.1f}s")

    # ---- phase 2: MSM at the prover's sizes ------------------------------
    t0 = time.perf_counter()
    phase2(dev)
    log(f"phase 2 msm closed forms: {time.perf_counter() - t0:.1f}s")

    # ---- phase 3: mint end to end ----------------------------------------
    t0 = time.perf_counter()
    counts = phase3(dev)
    log(f"phase 3 mint: {time.perf_counter() - t0:.1f}s")
    for name in kn.K:
        report[name]["launches"] = counts.get(name, 0)
    log("launch counts (mint phase):", json.dumps(counts))
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    log(f"total: {time.perf_counter() - t_all:.1f}s")
    order = ["butterfly", "mul_elementwise", "add", "double", "msm_round",
             "msm_fold", "mixed_add", "mixed_add_noexc"]
    log(json.dumps({"kernels": [report[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def rand_field(rng, shape, dev):
    """Canonical random limbs: the top limb stays below the moduli's
    (0x3064), so every value is < p for both Fq and Fr."""
    a = rng.integers(0, 1 << 16, size=shape + (16,), dtype=np.int64)
    a[..., 15] = rng.integers(0, 0x3064, size=shape)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def rand_coord(curve, rng, n, dev):
    return rand_field(rng, (n,) if curve == "g1" else (n, 2), dev)


def with_edge_lanes(P, Q):
    """Make lanes 0-1 infinite P, 2-3 infinite Q, 4-5 both, 6-7 Q = P and
    8-9 Q = -P (same X and Z, negated Y)."""
    from blockmaze_tpu_torch.fields import tfield as tf
    P = [t.clone() for t in P]
    Q = [t.clone() for t in Q]
    P[2][0:2] = 0
    Q[2][2:4] = 0
    P[2][4:6] = 0
    Q[2][4:6] = 0
    for k in range(3):
        Q[k][6:10] = P[k][6:10]
    Q[1][8:10] = tf.neg(tf.FQ, P[1][8:10]).to(torch.int32)
    return tuple(P), tuple(Q)


def same(a, b) -> bool:
    return all(torch.equal(x.to(torch.int64), y.to(torch.int64))
               for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def phase1(dev, rng, report):
    from blockmaze_tpu_torch.curves import pcurve as pc
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.msm import pippenger as pp
    from blockmaze_tpu_torch.ntt import pntt

    def check(name, shape, kern, plain, reps=5):
        got = kern()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        pms = start.elapsed_time(end)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ok = same(got, want)
        ms = timed(kern, reps)
        log(f"  {name:<22} {shape:<34} bit-exact={ok} max_abs_err={err} "
            f"kernel {ms:.4f} ms  plain {pms:.3f} ms")
        if not ok:
            raise AssertionError(f"{name}: kernel != plain at {shape}")
        return err, ms, pms

    def record(key, res):
        err, ms, pms = res
        r = report[key]
        r["max_abs_err"] = max(err, r.get("max_abs_err", 0))
        r.setdefault("ms", ms)           # the first (G1) shape's times
        r.setdefault("plain_ms", pms)

    # warm the plain path's torch kernels so its first timing is not a
    # measure of CUDA module loading
    w = rand_field(rng, (4,), dev)
    pntt.mul_elementwise_plain(w, w)
    tf.sub(tf.FQ, w, w)
    # K2: pointwise Fr product, 2^16 elements; K1: one stage of 2^16
    # butterflies (span 2^15, the last stage of mint's 2^17 FFT)
    a = rand_field(rng, (1 << 16,), dev)
    b = rand_field(rng, (1 << 16,), dev)
    record("mul_elementwise", check(
        "mul_elementwise", "Fr (2^16, 16)",
        lambda: pntt.mul_elementwise(a, b),
        lambda: pntt.mul_elementwise_plain(a, b), reps=20))
    m, span = 1 << 17, 1 << 15
    x = rand_field(rng, (m,), dev)
    tw = rand_field(rng, (span,), dev)
    record("butterfly", check(
        "butterfly", "Fr stage m=2^17 span=2^15",
        lambda: pntt.butterfly(x, tw, span),
        lambda: pntt.butterfly_plain(x, tw, span), reps=20))

    # K3, K4, K7, K8 at 2^14 (G1) and 2^12 (G2), with edge lanes
    for curve, n in (("g1", 1 << 14), ("g2", 1 << 12)):
        F = tc.ops(curve)
        P = tuple(rand_coord(curve, rng, n, dev) for _ in range(3))
        Q = tuple(rand_coord(curve, rng, n, dev) for _ in range(3))
        P, Q = with_edge_lanes(P, Q)
        qinf = torch.from_numpy(rng.random(n) < 0.05).to(dev)
        qinf[0:4] = torch.tensor([True, False, True, False], device=dev)
        Qa = [Q[0].clone(), Q[1].clone()]
        for k in range(2):   # lanes 6-9: affine Q = P's X and +-Y with Z = 1
            Qa[k][6:10] = P[k][6:10]
        Pm = [t.clone() for t in P]
        Pm[2][6:10] = F.one_like(Pm[2][6:10]).to(torch.int32)
        Qa[1][8:10] = tf.neg(tf.FQ, P[1][8:10]).to(torch.int32)
        shape = f"{curve} n={n}"
        record("add", check("add", shape, lambda: pc.add(curve, P, Q),
                            lambda: tc.point_add(F, P, Q)))
        record("double", check("double", shape, lambda: pc.double(curve, P),
                               lambda: tc.point_double(F, P)))
        record("mixed_add", check(
            "mixed_add", shape,
            lambda: pc.mixed_add(curve, Pm, Qa[0], Qa[1], qinf),
            lambda: tc.point_mixed_add(F, Pm, Qa[0], Qa[1], qinf)))
        record("mixed_add_noexc", check(
            "mixed_add_noexc", shape,
            lambda: pc.mixed_add_noexc(curve, Pm, Qa[0], Qa[1], qinf),
            lambda: tc.point_mixed_add_noexc(F, Pm, Qa[0], Qa[1], qinf)))

    # K5: the accumulation at T = 256 lanes, c = 8, blinded, G1 and G2 (on
    # real points: the exception-free add needs the blind argument)
    for curve, n in (("g1", 1 << 12), ("g2", 1 << 10)):
        pts, _ = curve_points(curve, n, dev)
        sc = torch.from_numpy(rng.integers(0, 1 << 16, (n, 16),
                                           dtype=np.int64)).to(dev)
        sc[:, 15] &= 0x3fff
        sc[5] = 0
        keys, pids, drop = pp.stream_keys(pts, sc, 8)
        T = 256
        L = -(-keys.shape[0] // T)
        pad = T * L - keys.shape[0]
        keys = torch.cat([keys, torch.full((pad,), drop, dtype=torch.int32,
                                           device=dev)])
        pids = torch.cat([pids, torch.zeros(pad, dtype=torch.int32,
                                            device=dev)])
        _, blind = pp.make_blind(curve, dev)

        def flat(res):
            acc, meta, head, bkt, cnt = res
            return tuple(acc) + (meta,) + tuple(head) + tuple(bkt) + (cnt,)

        record("msm_round", check(
            "msm_round", f"{curve} n={n} c=8 T=256 L={L}",
            lambda: flat(pp.accumulate(curve, keys, pids, pts, blind, T, L,
                                       drop)),
            lambda: flat(pp.accumulate_plain(curve, keys, pids, pts, blind,
                                             T, L, drop)), reps=3))

        # K6: the Horner fold of random window sums (22 windows, c = 12)
        win = tuple(rand_coord(curve, rng, 22, dev) for _ in range(3))
        record("msm_fold", check(
            "msm_fold", f"{curve} W=22 c=12",
            lambda: pp.fold(curve, 12, win),
            lambda: pp.fold_plain(curve, 12, win), reps=3))


def curve_points(curve, n, dev):
    """Affine points i*G for i = 1..n as device tensors, built by a host
    chain of additions; returns (points, [host affine])."""
    from blockmaze_tpu.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    if curve == "g1":
        G, add, conv = HC.g1_generator(), HC.g1_add, tc.g1_affine_to_device
    else:
        G, add, conv = HC.g2_generator(), HC.g2_add, tc.g2_affine_to_device
    pts = [G]
    for _ in range(n - 1):
        pts.append(add(pts[-1], G))
    x, y, inf = conv(pts)
    return (tf.to_tensor(x, dev), tf.to_tensor(y, dev),
            torch.from_numpy(inf).to(dev)), pts


# ---------------------------------------------------------------------------
# Phase 2: MSM at real sizes against the closed form
# ---------------------------------------------------------------------------

def phase2(dev):
    from blockmaze_tpu.curves import host_curve as HC
    from blockmaze_tpu.fields.constants import R_MOD
    from blockmaze_tpu_torch.curves import tcurve as tc
    from blockmaze_tpu_torch.fields import tfield as tf
    from blockmaze_tpu_torch.msm import pippenger as pp

    py = random.Random(SEED)
    for curve, logn in (("g1", 18), ("g2", 14)):
        n = 1 << logn
        t0 = time.perf_counter()
        pts, _ = curve_points(curve, n, dev)
        ks = [py.randrange(R_MOD) for _ in range(n)]
        sc = tf.to_tensor(tf.ints_to_limbs(ks), dev)
        t_in = time.perf_counter() - t0
        c = pp.default_window(n)
        R, blind = pp.make_blind(curve, dev)
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pp.msm(curve, pts, sc, c, 32768, blind=blind)
            torch.cuda.synchronize()
            t_msm = time.perf_counter() - t0
            log(f"  msm {curve} n=2^{logn} c={c} lanes=32768 run {rep}: "
                f"{t_msm * 1e3:.1f} ms")
        to_host = tc.g1_jacobian_to_host if curve == "g1" \
            else tc.g2_jacobian_to_host
        got = pp.unblind_msm(curve, to_host(tuple(v[None] for v in res[:3]))[0],
                             res[3].cpu().numpy(), R, c)
        k = sum((i + 1) * ki for i, ki in enumerate(ks)) % R_MOD
        want = (HC.g1_mul(HC.g1_generator(), k) if curve == "g1"
                else HC.g2_mul(HC.g2_generator(), k))
        log(f"  msm {curve} n=2^{logn} equals (sum i*k_i)*G: {got == want} "
            f"(inputs built in {t_in:.1f}s)")
        if got != want:
            raise AssertionError(f"msm {curve} 2^{logn} != closed form")


# ---------------------------------------------------------------------------
# Phase 3: mint end to end
# ---------------------------------------------------------------------------

def mint_protoboard():
    """The mint circuit with its constraints and the witness of
    scripts/witnesses.py (sk = 1, r_old = 123456, r = 123, values 6/13/7)."""
    from blockmaze_tpu.circuits.mint import MintGadget
    from blockmaze_tpu.crypto import notes as NT
    from blockmaze_tpu.r1cs.protoboard import Protoboard
    sk, r_old, r = (NT.uint256_from_hex(h) for h in ("1", "123456", "123"))
    note_old = NT.Note(6, NT.compute_prf(sk, r_old), r_old)
    note = NT.Note(13, NT.compute_prf(sk, r), r)
    pb = Protoboard()
    g = MintGadget(pb)
    g.generate_constraints()
    g.generate_witness(note_old, note, note_old.cm(), note.cm(), 7, sk)
    return pb


def phase3(dev):
    from blockmaze_tpu.groth16 import verifier
    from blockmaze_tpu_torch.groth16 import generator
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.utils import kernels as kn

    kn.reset_counts()
    t0 = time.perf_counter()
    pb = mint_protoboard()
    if not pb.is_satisfied():
        raise AssertionError("mint witness does not satisfy its constraints")
    log(f"  mint circuit: {pb.num_variables} variables, "
        f"{len(pb.constraints)} constraints "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "blockmaze_tpu_torch", "_keys")
    dpk, vk, generated = generator.generate_cached(pb, dev, "mint", SEED,
                                                   cache)
    torch.cuda.synchronize()
    log(f"  keygen (seed {SEED}) + npz/vk cache write and load: "
        f"{time.perf_counter() - t0:.1f}s"
        if generated else
        f"  keys loaded from {cache} ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    prover = Prover(dpk, dev)
    torch.cuda.synchronize()
    log(f"  Prover(cuda:0): {time.perf_counter() - t0:.1f}s "
        f"(domain m={prover.domain.m}, nA={prover.nA}, nB={prover.nB}, "
        f"nH={prover.nH}, nL={prover.nL}, c={prover.window}, "
        f"lanes={prover.lanes})")
    primary, aux = pb.primary_input(), pb.auxiliary_input()
    proofs = []
    for i, (r, s) in enumerate(((1, 2), (1, 2), (None, None))):
        t0 = time.perf_counter()
        proof = prover.prove(primary, aux, r=r, s=s)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = verifier.verify(vk, primary, proof)
        phases = {k: round(v, 4) for k, v in prover.timings.items()}
        log(f"  prove {i} ({'first' if i == 0 else 'steady'}): {dt:.3f}s "
            f"phases {json.dumps(phases)}; verify {ok} "
            f"({time.perf_counter() - t0:.1f}s)")
        if not ok:
            raise AssertionError(f"mint proof {i} rejected by the verifier")
        proofs.append(proof)
    if proofs[0] != proofs[1]:
        raise AssertionError("two proofs with equal (r, s) differ")
    log("  proofs 0 and 1 (equal r, s; fresh blinds) equal: True")
    counts = kn.counts()
    profile_prove(prover, primary, aux)
    if not generated:   # keygen's kernels did not run in this run
        for k in ("mixed_add", "mixed_add_noexc"):
            counts.pop(k)
    return counts


def profile_prove(prover, primary, aux):
    """One more steady proof under torch.profiler: device time by kernel
    and the device's busy share of the proof's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove(primary, aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if dev_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    log(f"  profiled steady prove: wall {wall:.3f}s (profiler on), device "
        f"busy {busy * 1e3:.1f} ms = {100 * busy / wall:.1f}% of wall")
    for key, us, n in rows[:12]:
        log(f"    {us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")


if __name__ == "__main__":
    main()
