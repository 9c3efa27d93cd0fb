"""What the port's operator drivers share.

Each driver runs on the card unless given `--device cpu` (the kernels'
plain versions, as the tests run them); without a card and without that
flag it raises before doing any work. It prints the card's line first
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`), then
its lines, an OK line, and last a one-line JSON summary of what it
measured.

Keys: with `--key-dir D` a driver reads the reference's D/<circ>pk.txt
(or the npz cache load_or_build writes beside it) and D/<circ>vk.txt, as
the JAX scripts read reference_harness/prfKey/; without it, the keys of
seed SEED that chip_smoke.py caches in blockmaze_tpu_torch/_keys/
(generate_cached: keygen on a miss, once).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..circuits import instances
from ..groth16 import generator
from ..groth16 import keys as K
from ..serialization import libsnark_io as io
from ..utils import kernels as kn

# the toxic waste's seed of the seeded keys in KEY_CACHE, which the
# drivers and chip_smoke.py share
SEED = 20261016
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY_CACHE = os.path.join(PKG, "_keys")
# the reference's verifiers (reference_harness/build_reference.sh builds
# them from the reference's sources; absent from a plain checkout)
ORACLE_DIR = os.path.join(os.path.dirname(PKG), "reference_harness",
                          "build")
ORACLE = {"mint": "oracle", "send": "oracle_send",
          "redeem": "oracle_redeem", "deposit": "oracle_deposit",
          "deposit20": "oracle_deposit"}


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the driver's docstring as its help and
    --device."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: the card; raises without one), "
                        "cuda:N, or cpu (the kernels' plain versions)")
    return p


def add_prover_args(p: argparse.ArgumentParser):
    """--lanes and --window (the Prover's defaults when not given) and
    --key-dir."""
    p.add_argument("--lanes", type=int, default=None,
                   help="most MSM accumulation lanes (Prover default)")
    p.add_argument("--window", type=int, default=None,
                   help="Pippenger window c (Prover default)")
    p.add_argument("--key-dir", default=None,
                   help="read <circ>pk.txt and <circ>vk.txt from this "
                        "directory (the reference's keys); default: the "
                        "seeded keys of blockmaze_tpu_torch/_keys/")


def device(name: str) -> torch.device:
    """The torch device `name`; a card's with its index. Raises when it
    names a card and none is visible: nothing carries on on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is "
                               f"visible; pass --device cpu to run on the "
                               f"CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_line() -> str:
    """Every card's `name, power limit` from nvidia-smi, joined by "; "."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: unavailable ({e})"
    lines = res.stdout.strip().splitlines()
    return "; ".join(lines) if res.returncode == 0 and lines \
        else "nvidia-smi: unavailable"


def say(*a):
    print(*a, flush=True)


def start(args) -> torch.device:
    """The driver's device (device(args.device)), after which the card's
    line and the versions are printed (banner)."""
    dev = device(args.device)
    banner(dev)
    return dev


def banner(dev):
    """The card's line and the versions."""
    if dev.type == "cuda":
        say(card_line())
        say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
            f"{dev} {torch.cuda.get_device_name(dev)}")
    else:
        say(f"torch {torch.__version__} device cpu (the kernels' plain "
            f"versions)")


def emit(summary: dict):
    """The one-line JSON summary."""
    say(json.dumps(summary))


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(fn, dev):
    """(fn(), its seconds by the host clock), the device synced before and
    after."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


class Laps:
    """Consecutive intervals on the device's clock: CUDA events on the
    device's current stream on a card, the host clock on the CPU (where
    every op has finished when it returns)."""

    def __init__(self, dev):
        self.dev = torch.device(dev)
        self.marks = []

    def mark(self, label: str | None = None):
        """End the interval `label` (None: the start)."""
        if self.dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.dev))
            self.marks.append((label, e))
        else:
            self.marks.append((label, time.perf_counter()))

    def ms(self) -> dict:
        """{label: milliseconds since the mark before it}, in order."""
        sync(self.dev)
        out = {}
        for (_, a), (label, b) in zip(self.marks, self.marks[1:]):
            out[label] = (a.elapsed_time(b) if self.dev.type == "cuda"
                          else (b - a) * 1e3)
        return out


def launches() -> dict:
    """The kernels launched since the last kn.reset_counts(), with their
    counts."""
    return {k: v for k, v in kn.counts().items() if v}


@dataclass
class Keys:
    dpk: K.DevicePK
    vk: io.VerificationKey
    vk_path: str
    source: str        # "key dir", "seeded cache" or "keygen"
    seconds: float


def resolve_keys(name: str, dev, key_dir: str | None = None, make_pb=None,
                 cache: str = KEY_CACHE) -> Keys:
    """Circuit `name`'s keys on `dev`: with key_dir the reference's text
    key through keys.load_or_build and its vk (read first, so a missing vk
    fails before a long load); else generate_cached's seeded keys in
    `cache`, synthesising the circuit (make_pb(), default
    instances.protoboard(name)) only when they are not cached yet."""
    t0 = time.perf_counter()
    if key_dir:
        vk_path = os.path.join(key_dir, f"{name}vk.txt")
        vk = io.load_verification_key(vk_path)
        dpk = K.load_or_build(os.path.join(key_dir, f"{name}pk.txt"),
                              device=dev)
        source = "key dir"
    else:
        vk_path = generator.cache_paths(name, SEED, cache)[1]
        dpk, vk, generated = generator.generate_cached(
            make_pb or (lambda: instances.protoboard(name)), name, SEED,
            cache, dev)
        source = "keygen" if generated else "seeded cache"
    return Keys(dpk, vk, vk_path, source, time.perf_counter() - t0)


def key_digests(npz: str, vk_path: str) -> dict:
    """sha256 (first 16 hex digits) of every array of a DevicePK npz (its
    dtype, shape and bytes) and of the vk file, and one sha256 over all of
    them ("all")."""
    out = {}
    with np.load(npz) as z:
        for k in sorted(z.files):
            a = np.ascontiguousarray(z[k])
            h = hashlib.sha256(f"{a.dtype.str} {a.shape} ".encode())
            h.update(a.tobytes())
            out[k] = h.hexdigest()[:16]
    with open(vk_path, "rb") as f:
        out["vk"] = hashlib.sha256(f.read()).hexdigest()[:16]
    out["all"] = hashlib.sha256(json.dumps(out, sort_keys=True)
                                .encode()).hexdigest()
    return out


def oracle_verify(name: str, vk_path: str, proof, primary):
    """The reference's own verifier on the proof: (accepted, its last
    line), or None when the circuit has none or its binary is not built
    (ORACLE_DIR)."""
    exe = os.path.join(ORACLE_DIR, ORACLE.get(name, ""))
    if name not in ORACLE or not os.path.exists(exe):
        return None
    with tempfile.TemporaryDirectory() as tmp:
        pf = os.path.join(tmp, "proof.txt")
        pi = os.path.join(tmp, "primary.txt")
        io.write_proof(pf, proof)
        io.write_primary_input(pi, primary)
        res = subprocess.run([exe, "verify", vk_path, pf, pi],
                             capture_output=True, text=True)
    lines = res.stdout.strip().splitlines()
    return "VERIFY_OK" in res.stdout, (lines[-1] if lines
                                       else res.stderr.strip())
