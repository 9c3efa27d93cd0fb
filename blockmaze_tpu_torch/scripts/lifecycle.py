"""The node lifecycle with real Groth16 proofs: mint -> send -> deposit ->
redeem through Node, the chain state and ZkTx, every proof made by the
port's prover and verified twice (pool admission and block import),
through the hex wire encoding. This is the reference's 5-node runbook
(test/clique/instructions.txt) on the in-process Network.

Keys: the seeded keys of blockmaze_tpu_torch/_keys/ (keygen of any that
is missing), linked into a ZkTx key directory _keys/zktx_d<depth>/ (the
depth-20 service's deposit key is deposit20's); or --key-dir D, a
directory of <circ>pk.txt (or its npz) and <circ>vk.txt for that depth.

    python -m blockmaze_tpu_torch.scripts.lifecycle [--depth 8|20]
        [--lanes N] [--key-dir D] [--device cuda]
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from ..groth16 import generator
from ..groth16 import keys as K
from ..node import Network, Node
from ..node.node import NodeError
from ..utils import kernels as kn
from ..zktx.api import ZkTx
from . import _common as cm

SERVICE_CIRCUITS = ["mint", "send", "deposit", "redeem"]


def key_name(name: str, depth: int) -> str:
    """The seeded cache's name of the service's key for `name`."""
    return "deposit20" if name == "deposit" and depth == 20 else name


def service_keys(depth: int) -> str:
    """A key directory for ZkTx at Merkle depth `depth`: <name>pk.v1.npz
    and <name>vk.txt linked to the seeded keys of _common.KEY_CACHE at
    generator.cache_paths (deposit20's as deposit at depth 20);
    keys.load_or_build takes the npz when the text key is absent."""
    kdir = os.path.join(cm.KEY_CACHE, f"zktx_d{depth}")
    os.makedirs(kdir, exist_ok=True)
    for name in SERVICE_CIRCUITS:
        paths = generator.cache_paths(key_name(name, depth), cm.SEED,
                                      cm.KEY_CACHE)
        wants = (f"pk.v{K.CACHE_VERSION}.npz", "vk.txt")
        for target, want in zip(paths, wants):
            if not os.path.exists(target):
                raise FileNotFoundError(f"{target}: no seeded key (keygen "
                                        f"writes it)")
            link = os.path.join(kdir, name + want)
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(target, link)
    return kdir


def instrument(svc):
    """Wrap the service's gen_*_proof and verify_*_proof and each prover's
    prove (instance attributes over the methods) to record, per call, its
    seconds, its result (ok) and for prove the prover's phases. Returns
    the record lists."""
    rec = {"gen": [], "prove": [], "verify": []}

    def wrap(obj, attr, key, prover=None):
        fn = getattr(obj, attr)

        def timed_call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            entry = {"s": time.perf_counter() - t0, "ok": out}
            if prover is not None:
                entry["phases"] = dict(prover.timings)
            rec[key].append(entry)
            return out

        setattr(obj, attr, timed_call)

    for name in SERVICE_CIRCUITS:
        prover = svc.circuits[name].prover
        wrap(prover, "prove", "prove", prover)
        wrap(svc, f"gen_{name}_proof", "gen")
        wrap(svc, f"verify_{name}_proof", "verify")
    return rec


def run_lifecycle(svc, check=None):
    """On a warm ZkTx: a Network with alice and bob Nodes in temporary
    datadirs, mint 100 -> send 40 -> deposit -> redeem 25 with a block
    mined after each; every proof verified at pool admission and at block
    import; the balances of scripts/lifecycle.py (wallets: alice 60, bob
    15; chain: alice 400, bob 35); a double deposit rejected; alice's
    wallet reloaded from alice's datadir. Per transaction: synthesis, prove
    (with phases) and verify seconds and the launches, which check(circuit
    name, launches), if given, may reject by raising. Prints a `lifecycle
    summary` line. Returns (each transaction's launches, the summary's
    rows); raises on any failed check."""
    rec = instrument(svc)
    path_counts, rows = [], []
    with tempfile.TemporaryDirectory(prefix="bm_lifecycle_") as tmp:
        net = Network(svc, seed=42)
        da, db = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        alice, bob = Node(net, da), Node(net, db)
        net.fund(alice.address, 500)
        net.fund(bob.address, 10)

        def tx(label, name, fn, mine=True):
            for v in rec.values():
                v.clear()
            kn.reset_counts()
            t0 = time.perf_counter()
            try:
                out = fn()
                blk = net.mine_block() if mine else None
            finally:
                cm.sync(svc.device)
                path_counts.append(kn.counts())
                wall = time.perf_counter() - t0
            if len(rec["gen"]) != 1 or len(rec["prove"]) != 1:
                raise AssertionError(f"{label}: {len(rec['prove'])} proofs")
            if mine and [v["ok"] for v in rec["verify"]] != [True, True]:
                raise AssertionError(f"{label}: verified {rec['verify']}")
            if check is not None:
                check(name, path_counts[-1])
            p = rec["prove"][0]
            row = {"tx": label, "synthesis_s": round(
                rec["gen"][0]["s"] - p["s"], 3), "prove_s": round(p["s"], 4),
                "phases": {k: round(v, 4) for k, v in p["phases"].items()},
                "verify_s": [round(v["s"], 3) for v in rec["verify"]],
                "wall_s": round(wall, 2)}
            rows.append(row)
            cm.say(f"  [{label}] synthesis {row['synthesis_s']}s, prove "
                   f"{row['prove_s']}s phases {json.dumps(row['phases'])}, "
                   f"verify {row['verify_s']}s"
                   + (f", block #{blk['number']} cmts={len(blk['cmt'])}"
                      if blk else ""))
            return out

        tx("mint alice +100", "mint", lambda: alice.send_mint_transaction(100))
        h_send = tx("send alice->bob 40", "send",
                    lambda: alice.send_send_transaction(
                        40, bob.get_pub_key_rlp()))
        tx("deposit bob claims", "deposit",
           lambda: bob.send_deposit_transaction(h_send))
        tx("redeem bob -25", "redeem", lambda: bob.send_redeem_transaction(25))
        ba, bb = alice.get_balance2(), bob.get_balance2()
        cm.say(f"  alice: {ba}")
        cm.say(f"  bob:   {bb}")
        if (ba["wallet_value"], bb["wallet_value"], net.balance_of(
                bob.address), net.balance_of(alice.address)) != \
                (60, 15, 35, 400):
            raise AssertionError("lifecycle balances differ from "
                                 "scripts/lifecycle.py's")

        def double_deposit():
            try:
                bob.send_deposit_transaction(h_send)
            except NodeError as e:
                cm.say(f"  double deposit rejected: {e}")
                return
            raise AssertionError("double deposit was not rejected")

        tx("double deposit (rejected)", "deposit", double_deposit,
           mine=False)
        if Node(net, da).wallet.sequence_number_after.value != 60:
            raise AssertionError("alice's wallet did not reload from its "
                                 "datadir")
        cm.say("  alice's wallet reloaded from its datadir: value 60")
    cm.say(f"  lifecycle summary: "
           f"{json.dumps({'depth': svc.merkle_depth, 'txs': rows})}")
    return path_counts, rows


def main(argv=None):
    p = cm.parser(__doc__)
    p.add_argument("--depth", type=int, choices=[8, 20], default=8)
    p.add_argument("--lanes", type=int, default=None,
                   help="most MSM accumulation lanes (Prover default)")
    p.add_argument("--key-dir", default=None,
                   help="ZkTx's key directory for this depth; default: "
                        "the seeded keys of blockmaze_tpu_torch/_keys/")
    args = p.parse_args(argv)
    dev = cm.start(args)
    t_all = time.perf_counter()
    kdir = args.key_dir
    if kdir is None:
        for name in SERVICE_CIRCUITS:
            keys = cm.resolve_keys(key_name(name, args.depth), dev)
            cm.say(f"[{name}] key ({keys.source}): {keys.seconds:.1f}s")
        kdir = service_keys(args.depth)
    t0 = time.perf_counter()
    svc = ZkTx(kdir, merkle_depth=args.depth, device=dev)
    svc.warm()
    if args.lanes:
        for name in SERVICE_CIRCUITS:
            svc.circuits[name].prover.lanes = args.lanes
    cm.say(f"[warm] all 4 provers loaded in {time.perf_counter() - t0:.1f}s "
           f"(keys, Provers, kernel library)")
    counts, rows = run_lifecycle(svc)
    total = time.perf_counter() - t_all
    summary = {"metric": "lifecycle", "depth": args.depth,
               "device": str(dev), "txs": rows, "total_s": total,
               "launches": {k: sum(c[k] for c in counts) for k in kn.K
                            if any(c[k] for c in counts)}}
    cm.say(f"LIFECYCLE OK (depth {args.depth}, real proofs, {total:.1f}s "
           f"total)")
    cm.emit(summary)


if __name__ == "__main__":
    main()
