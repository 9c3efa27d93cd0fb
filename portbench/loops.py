"""The traffic generator: one closed-loop client per kind of traffic mix.

A mix's file names its kind and the kind's parameters:

- prove  {"pool": P}: one proof at a time through Prover.prove, cycling
  over P distinct transactions' witnesses, with fresh (r, s) each proof;
- batch  {"batch": B}: Prover.prove_batch of B distinct witnesses, batch
  after batch, with fresh (r, s) for every proof;
- tx     {}: one transaction at a time through the configuration's
  service, a wallet's proof call and a node's verify call, each
  transaction new.

"warm" (batch, tx) sets how many batches or transactions warm up.

What serves prove and batch traffic: the configuration's prover(dpk,
devices), where its .py defines one, is handed the deployment's proving
key and the cell's cards (ctx.devices, in order); otherwise the loop builds
Prover(dpk, ctx.device), one card's. The object provides prove(primary,
aux, r=, s=) -> proof; prove_batch(witnesses, rs, ss) -> proofs, in order;
timings, the last call's laps ("wires", "qap", "msm", "combine" after
prove; "blinds", "dispatch", "drain" after prove_batch), which
prove_phases and Batch.phases read; close(); and, where a traced prove
cell's metrics read them (portbench.peaks.msm_round_work), msm_inputs,
window and lanes, as Prover has them.

Everything a run sends comes from its seed: the transactions from the
stream "pool" (or "tx"), the draws (r, s) from the stream "draws", so one
seed gives the same requests in the same order, and every seed the same
sizes. A loop's request(n) makes request n and returns its record; phases
(record) splits it into (what the host was doing, start, end) on the
host's clock.
"""

from __future__ import annotations

import os
import random
import time

from .reference.bn254 import R_MOD


def stream(seed: int, name: str) -> random.Random:
    """The seed's random stream `name`."""
    return random.Random(f"{seed}:{name}")


def program_key(dpk, vk) -> dict:
    """The program's proving-key constants and verification key as plain
    tuples, for the reference to judge."""
    rest = [p for _, p in sorted(vk.gamma_ABC_rest)]
    return {"alpha_g1": dpk.alpha_g1, "beta_g1": dpk.beta_g1,
            "beta_g2": dpk.beta_g2, "delta_g1": dpk.delta_g1,
            "delta_g2": dpk.delta_g2, "gamma_g2": vk.gamma_g2,
            "delta_g2_vk": vk.delta_g2, "alpha_beta": vk.alpha_g1_beta_g2,
            "ic": [vk.gamma_ABC_first] + rest}


def plain_proof(proof):
    return proof.a, proof.b, proof.c


class Keys:
    """The deployment's keys from the program's seeded keygen, cached in
    `cache_dir` (keygen on a miss: a cell's first run in a checkout)."""

    def __init__(self, ctx):
        from blockmaze_tpu_torch.groth16 import generator
        cfg = ctx.config
        self.cache_dir = os.path.join(ctx.cache_dir, "keys")
        self.npz, self.vk_path = generator.cache_paths(
            cfg["circuit"], ctx.setup_seed, self.cache_dir)
        self.dpk, self.vk, self.generated = generator.generate_cached(
            ctx.prog.protoboard, cfg["circuit"], ctx.setup_seed,
            self.cache_dir, ctx.device)


class Laps(dict):
    """Seconds of the set-up's steps, by name, in order."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def __call__(self, label: str):
        now = time.perf_counter()
        self[label] = self.get(label, 0.0) + now - self.t
        self.t = now


def prove_phases(t0: float, timings: dict):
    out = []
    for label in ("wires", "qap", "msm", "combine"):
        d = timings.get(label, 0.0)
        out.append((label, t0, t0 + d))
        t0 += d
    return out


class Prove:
    kind = "prove"
    size_key = "pool"     # the traffic's key that sets the pool's size

    def __init__(self, ctx):
        self.ctx = ctx
        self.pool_size = ctx.traffic[self.size_key]

    def setup(self):
        """The keys, what serves the traffic (the module's docstring), and
        the seed's pool, warmed."""
        from blockmaze_tpu_torch.groth16.prover import Prover
        ctx = self.ctx
        self.laps = Laps()
        self.keys = Keys(ctx)
        self.laps("keys")
        serve = getattr(ctx.prog, "prover", None)
        if serve is None:
            self.prover = Prover(self.keys.dpk, ctx.device)
        else:
            self.prover = serve(self.keys.dpk, ctx.devices)
        self.laps("prover")
        self.make_pool(ctx.seed)

    def witnesses_of(self, seed: int):
        """The seed's transactions and their witnesses, and its draws."""
        ctx = self.ctx
        rng = stream(seed, "pool")
        self.txs = [ctx.ref.transaction(rng) for _ in range(self.pool_size)]
        self.witnesses = [ctx.prog.witness(tx, ctx.config) for tx in self.txs]
        self.laps("pool")
        self.draws = stream(seed, "draws")
        self.work = []
        return stream(seed, "warm")

    def make_pool(self, seed: int):
        """The seed's pool, each witness proved once: the warm-up, whose
        proofs (base) the judge holds the window's proofs of the same
        witness to, and under the trace the MSM work each witness gives."""
        warm = self.witnesses_of(seed)
        self.base = []
        for w in self.witnesses:
            r, s = warm.randrange(1, R_MOD), warm.randrange(1, R_MOD)
            self.base.append((r, s, plain_proof(self.prover.prove(*w, r=r,
                                                                 s=s))))
            if self.ctx.trace:
                from . import peaks
                self.work.append(peaks.msm_round_work(self.prover))
        self.laps("warm-up")

    def request(self, n: int) -> dict:
        k = n % self.pool_size
        r, s = self.draws.randrange(1, R_MOD), self.draws.randrange(1, R_MOD)
        t0 = time.perf_counter()
        proof = self.prover.prove(*self.witnesses[k], r=r, s=s)
        t1 = time.perf_counter()
        return {"slot": k, "r": r, "s": s, "t0": t0, "t1": t1,
                "timings": dict(self.prover.timings), "proof": proof}

    def phases(self, rec):
        return prove_phases(rec["t0"], rec["timings"])

    def proofs(self, records):
        """(slot, r, s, proof) of every proof in the window."""
        return [(rec["slot"], rec["r"], rec["s"], plain_proof(rec["proof"]))
                for rec in records]

    def primaries(self):
        return [w[0] for w in self.witnesses]

    def program_key(self):
        return program_key(self.keys.dpk, self.keys.vk)

    def close(self):
        self.prover.close()
        self.prover = self.keys = None


class Batch(Prove):
    kind = "batch"
    size_key = "batch"

    def make_pool(self, seed: int):
        """The seed's B witnesses and `warm` warm-up batches (default 2;
        the first starts the prover's host workers), the last one's proofs
        the judge's base."""
        warm = self.witnesses_of(seed)
        for _ in range(self.ctx.traffic.get("warm", 2)):
            rs = [warm.randrange(1, R_MOD) for _ in self.witnesses]
            ss = [warm.randrange(1, R_MOD) for _ in self.witnesses]
            proofs = self.prover.prove_batch(self.witnesses, rs, ss)
        self.base = [(r, s, plain_proof(p)) for r, s, p in zip(rs, ss,
                                                               proofs)]
        self.laps("warm-up")

    def request(self, n: int) -> dict:
        B = self.pool_size
        rs = [self.draws.randrange(1, R_MOD) for _ in range(B)]
        ss = [self.draws.randrange(1, R_MOD) for _ in range(B)]
        t0 = time.perf_counter()
        proofs = self.prover.prove_batch(self.witnesses, rs, ss)
        t1 = time.perf_counter()
        return {"rs": rs, "ss": ss, "t0": t0, "t1": t1,
                "timings": dict(self.prover.timings), "proofs": proofs}

    def phases(self, rec):
        out, t = [], rec["t0"]
        for label in ("blinds", "dispatch", "drain"):
            d = rec["timings"].get(label, 0.0)
            out.append((label, t, t + d))
            t += d
        return out

    def proofs(self, records):
        return [(k, r, s, plain_proof(p)) for rec in records
                for k, (r, s, p) in enumerate(zip(rec["rs"], rec["ss"],
                                                  rec["proofs"]))]


class Tx:
    kind = "tx"

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self):
        """The configuration's service on the deployment's keys, under the
        file names it reads (<circuit>pk.v1.npz, <circuit>vk.txt), warmed
        for this circuit, then `warm` transactions (default 2)."""
        ctx = self.ctx
        circ = ctx.config["circuit"]
        self.laps = Laps()
        self.keys = Keys(ctx)
        self.laps("keys")
        key_dir = os.path.join(ctx.cache_dir,
                               f"service_{circ}_s{ctx.setup_seed}")
        os.makedirs(key_dir, exist_ok=True)
        for src, dst in ((self.keys.npz, f"{circ}pk.v1.npz"),
                         (self.keys.vk_path, f"{circ}vk.txt")):
            dst = os.path.join(key_dir, dst)
            if os.path.exists(dst):
                os.remove(dst)
            os.link(src, dst)
        self.svc = ctx.prog.service(key_dir, ctx.config, ctx.device)
        self.circuit = self.svc.circuits[circ]
        self.laps("service")
        self.make_pool(ctx.seed)

    def make_pool(self, seed: int):
        warm = stream(seed, "warm")
        for _ in range(self.ctx.traffic.get("warm", 2)):
            tx = self.ctx.ref.transaction(warm)
            proof_hex, _ = self.ctx.prog.prove_tx(self.svc, tx)
            self.ctx.prog.verify_tx(self.svc, tx, proof_hex)
        self.laps("warm-up")
        self.tx_stream = stream(seed, "tx")
        self.work = []

    def request(self, n: int) -> dict:
        tx = self.ctx.ref.transaction(self.tx_stream)
        t0 = time.perf_counter()
        proof_hex, primary = self.ctx.prog.prove_tx(self.svc, tx)
        t1 = time.perf_counter()
        verdict = self.ctx.prog.verify_tx(self.svc, tx, proof_hex)
        t2 = time.perf_counter()
        return {"tx": tx, "proof_hex": proof_hex, "primary": primary,
                "verdict": verdict, "t0": t0, "t1": t1, "t2": t2,
                "timings": dict(self.circuit.prover.timings)}

    def phases(self, rec):
        prove_s = sum(rec["timings"].values())
        start = rec["t1"] - prove_s
        return ([("synthesis", rec["t0"], start)]
                + prove_phases(start, rec["timings"])
                + [("verify", rec["t1"], rec["t2"])])

    def program_key(self):
        return program_key(self.circuit.prover.dpk, self.circuit.vk)

    def close(self):
        self.circuit.prover.close()
        self.svc = self.circuit = self.keys = None


KINDS = {k.kind: k for k in (Prove, Batch, Tx)}
