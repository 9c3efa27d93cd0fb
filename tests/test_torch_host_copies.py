"""The port's own copies of the JAX package's host modules agree with the
originals: the constants, the host curve group law, the verifier on one
toy proof, the mint circuit (variables, constraints and witness), and the
service-side modules copied verbatim (text-equal files)."""

import os
import random

import pytest
import torch

from blockmaze_tpu.circuits.mint import MintGadget as JaxMintGadget
from blockmaze_tpu.crypto import notes as JNT
from blockmaze_tpu.curves import host_curve as JHC
from blockmaze_tpu.fields import constants as JC
from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu.r1cs.protoboard import Protoboard as JaxProtoboard
from blockmaze_tpu_torch.circuits.mint import MintGadget
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.fields import constants as C
from blockmaze_tpu_torch.groth16 import generator, keys, verifier
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.r1cs.protoboard import LC, Protoboard

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules the port holds verbatim: their imports are relative, so the same
# text names the port's own modules
VERBATIM = ["config.py", "crypto/keccak.py", "zktx/__init__.py",
            "zktx/aux.py", "chain/__init__.py", "chain/state.py",
            "node/__init__.py", "node/node.py", "node/wallet.py",
            "r1cs/examples.py"]


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_equal(path):
    with open(os.path.join(ROOT, "blockmaze_tpu", path)) as f:
        want = f.read()
    with open(os.path.join(ROOT, "blockmaze_tpu_torch", path)) as f:
        assert f.read() == want


def test_constants_equal():
    names = sorted(n for n in vars(JC) if n.isupper())
    assert names and names == sorted(n for n in vars(C) if n.isupper())
    for n in names:
        assert getattr(C, n) == getattr(JC, n), n


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_host_curve_add_mul_equal(curve):
    rng = random.Random(5 if curve == "g1" else 6)
    g = getattr(HC, f"{curve}_generator")()
    assert g == getattr(JHC, f"{curve}_generator")()
    mul, jmul = getattr(HC, f"{curve}_mul"), getattr(JHC, f"{curve}_mul")
    add, jadd = getattr(HC, f"{curve}_add"), getattr(JHC, f"{curve}_add")
    pts = [mul(g, rng.randrange(1, C.R_MOD)) for _ in range(4)]
    for p in pts:
        k = rng.randrange(C.R_MOD)
        assert mul(p, k) == jmul(p, k)
        for q in pts + [p]:
            assert add(p, q) == jadd(p, q)


def toy_circuit(x: int, w: int):
    """Public x, witness w: w*w = x and (w+1)*(w-1) = x-1."""
    pb = Protoboard()
    vx = pb.allocate()
    pb.set_input_sizes(1)
    vw = pb.allocate()
    pb.add_constraint(LC.var(vw), LC.var(vw), LC.var(vx))
    pb.add_constraint(LC.var(vw) + 1, LC.var(vw) - 1, LC.var(vx) - 1)
    pb.setval(vx, x)
    pb.setval(vw, w)
    return pb


def test_verifier_equal_on_toy_proof():
    """A proof from the port's keygen and prover (plain versions, CPU):
    both verifiers accept it, and both reject it for another input."""
    w = 7654321
    pb = toy_circuit(w * w % C.R_MOD, w)
    assert pb.is_satisfied()
    toxic = iter([3, 5, 7, 11, 13])
    pk, vk = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    proof = Prover(keys.build_device_pk(pk), "cpu", lanes=8,
                   window=4).prove(pb.primary_input(), pb.auxiliary_input())
    x = pb.primary_input()
    assert verifier.verify(vk, x, proof) and jverifier.verify(vk, x, proof)
    bad = [(x[0] + 1) % C.R_MOD]
    assert not verifier.verify(vk, bad, proof)
    assert not jverifier.verify(vk, bad, proof)


def mint(pb_cls, gadget_cls, nt):
    sk, r_old, r = (nt.uint256_from_hex(h) for h in ("1", "123456", "123"))
    note_old = nt.Note(6, nt.compute_prf(sk, r_old), r_old)
    note = nt.Note(13, nt.compute_prf(sk, r), r)
    pb = pb_cls()
    g = gadget_cls(pb)
    g.generate_constraints()
    g.generate_witness(note_old, note, note_old.cm(), note.cm(), 7, sk)
    return pb


def test_mint_protoboard_equal():
    pb = mint(Protoboard, MintGadget, NT)
    jpb = mint(JaxProtoboard, JaxMintGadget, JNT)
    assert pb.num_variables == jpb.num_variables
    assert pb.primary_input_size == jpb.primary_input_size
    assert len(pb.constraints) == len(jpb.constraints)
    for (a, b, c), (ja, jb, jc) in zip(pb.constraints, jpb.constraints):
        assert (a.as_dict(), b.as_dict(), c.as_dict()) == \
            (ja.as_dict(), jb.as_dict(), jc.as_dict())
    assert pb.primary_input() == jpb.primary_input()
    assert pb.auxiliary_input() == jpb.auxiliary_input()
    assert pb.is_satisfied()
