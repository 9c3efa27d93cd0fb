"""The plain reference against the port on the CPU, and the reference's
imports: it loads nothing of JAX, the JAX package or the port."""

import json
import random
import subprocess
import sys
import textwrap

import pytest

from portbench import loops, spec
from portbench.reference import bn254 as B
from portbench.reference import groth16 as G
from portbench.reference import notes as N
from portbench.tests.conftest import REPO

CONFIG = {"merkle_depth": 8}


@pytest.mark.parametrize("name", ["mint", "deposit"])
def test_statement_is_the_ports_public_input(name):
    ref = spec.load_module(f"{REPO}/portbench/configs/{name}_ref.py")
    prog = spec.load_module(f"{REPO}/portbench/configs/{name}.py")
    rng = loops.stream(2**31 + 5, "pool")
    tx = ref.transaction(rng)
    primary, _ = prog.witness(tx, CONFIG)
    assert primary == ref.statement(tx, CONFIG)
    tx["value_s"] += 1
    assert prog.witness(tx, CONFIG)[0] != ref.statement(
        dict(tx, value_s=tx["value_s"] - 1), CONFIG)


def test_merkle_root_is_the_ports():
    from blockmaze_tpu_torch.merkle import incremental as MK
    rng = random.Random(3)
    leaves = [rng.randbytes(32) for _ in range(13)]
    tree = MK.IncrementalMerkleTree(8)
    for leaf in leaves:
        tree.append(leaf)
    assert N.merkle_root(leaves, 8) == tree.root()
    assert N.merkle_root([], 4) == MK.IncrementalMerkleTree.empty_root(4)


def test_pairing_and_verifier_agree_with_the_ports(checkout):
    """A chain proof of the port, judged by the reference and by the
    port's verifier: both accept it, both reject it for another statement
    or with C moved."""
    import os
    from blockmaze_tpu_torch.curves import host_curve as HC
    from blockmaze_tpu_torch.curves import pairing as P
    from blockmaze_tpu_torch.groth16 import generator, verifier
    from blockmaze_tpu_torch.groth16.prover import Prover
    from blockmaze_tpu_torch.r1cs.examples import chain_circuit
    cfg = spec.read_json(os.path.join(checkout, "portbench/configs/"
                                      "chain.json"))
    dpk, vk, _ = generator.generate_cached(
        None, "chain", cfg["setup_seed"],
        os.path.join(checkout, "portbench", "_cache", "keys"), "cpu")
    key = G.deployment_key(cfg["setup_seed"], cfg["vk_ic"])
    assert G.key_differences(key, loops.program_key(dpk, vk)) == []
    pb = chain_circuit(12, 5)
    proof = Prover(dpk, "cpu").prove(pb.primary_input(),
                                     pb.auxiliary_input(), r=3, s=4)
    plain = (proof.a, proof.b, proof.c)
    bad = [(pb.primary_input()[0] + 1) % B.R_MOD]
    moved = (proof.a, proof.b, HC.g1_add(proof.c, HC.g1_generator()))
    for statement, p, want in ((pb.primary_input(), plain, True),
                               (bad, plain, False),
                               (pb.primary_input(), moved, False)):
        assert G.verify(key, statement, p) is want
        assert verifier.verify(vk, statement, type(proof)(*p)) is want
    g1, g2 = B.g1_mul(B.g1_generator(), 5), B.g2_mul(B.g2_generator(), 7)
    assert B.pairing(g1, g2) == P.pairing(HC.g1_mul(HC.g1_generator(), 5),
                                          HC.g2_mul(HC.g2_generator(), 7))


def test_wire_encoding_is_the_ports():
    from blockmaze_tpu_torch.serialization import libsnark_io as io
    a = B.g1_mul(B.g1_generator(), 11)
    b = B.g2_mul(B.g2_generator(), 13)
    c = B.g1_mul(B.g1_generator(), 17)
    hexed = io.proof_to_hex(io.Proof(a=a, b=b, c=c))
    assert G.proof_from_wire(hexed) == (a, b, c)


def test_reference_imports_nothing_of_jax_or_the_port():
    code = textwrap.dedent(f"""
        import json, random, sys
        sys.path.insert(0, {REPO!r})
        from portbench import spec
        from portbench.reference import groth16, notes, bn254
        for name in ("mint", "deposit"):
            ref = spec.load_module(
                {REPO!r} + f"/portbench/configs/{{name}}_ref.py")
            tx = ref.transaction(random.Random(1))
            ref.statement(tx, {{"merkle_depth": 8}})
        groth16.deployment_key(7, [[1, 2], [1, 2]])
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    modules = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not modules & {"jax", "jaxlib", "flax", "blockmaze_tpu",
                          "blockmaze_tpu_torch", "torch"}
