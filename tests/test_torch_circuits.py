"""The port's circuits (blockmaze_tpu_torch/circuits/instances.py and the
host-module copies under it: merkle/incremental, r1cs/gadgets/merkle,
circuits/{send,redeem,deposit}) agree with the JAX package's: the same
instance values give equal variables, constraints, inputs and witnesses,
at deposit depths 8 and 20."""

import pytest

from blockmaze_tpu.circuits.deposit import DepositGadget as JaxDepositGadget
from blockmaze_tpu.circuits.mint import MintGadget as JaxMintGadget
from blockmaze_tpu.circuits.redeem import RedeemGadget as JaxRedeemGadget
from blockmaze_tpu.circuits.send import SendGadget as JaxSendGadget
from blockmaze_tpu.crypto import notes as JNT
from blockmaze_tpu.merkle import incremental as JMK
from blockmaze_tpu.r1cs.protoboard import Protoboard as JaxProtoboard
from blockmaze_tpu_torch.circuits import instances
from blockmaze_tpu_torch.circuits.deposit import DepositGadget
from blockmaze_tpu_torch.circuits.mint import MintGadget
from blockmaze_tpu_torch.circuits.redeem import RedeemGadget
from blockmaze_tpu_torch.circuits.send import SendGadget
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.merkle import incremental as MK
from blockmaze_tpu_torch.r1cs.protoboard import Protoboard

# reference constraint counts (tests/test_circuits.py); deposit20's from
# the JAX package's DepositGadget at depth 20
NUM_CONSTRAINTS = {"send": 252286, "redeem": 167853, "deposit": 503863,
                   "deposit20": 840451}


def _u256(nt, h):
    return nt.uint256_from_hex(h)


def deposit_tree(nt, mk, depth, cmtS):
    """The witness of leaf 9, cmtS, in a 16-leaf tree of Merkle module mk
    (the other leaves 1..16)."""
    tree = mk.IncrementalMerkleTree(depth)
    wit = None
    for i in range(16):
        leaf = cmtS if i == 9 else _u256(nt, str(i + 1))
        if wit is not None:
            wit.append(leaf)
        else:
            tree.append(leaf)
        if i == 9:
            wit = tree.witness()
    return wit


def public_values(nt, mk, name):
    """The arguments of circuit `name`'s witness_map for its instance
    (scripts/witnesses.py's values), from notes module nt and Merkle
    module mk of either package."""
    sk = _u256(nt, "1")
    r_old = _u256(nt, "123456")
    sn_old = nt.compute_prf(sk, r_old)
    if name == "mint":
        r = _u256(nt, "123")
        note = nt.Note(13, nt.compute_prf(sk, r), r)
        return nt.Note(6, sn_old, r_old).cm(), sn_old, note.cm(), 7
    if name == "redeem":
        r = _u256(nt, "123")
        note = nt.Note(6, nt.compute_prf(sk, r), r)
        return nt.Note(13, sn_old, r_old).cm(), sn_old, note.cm(), 7
    pk_recv = int("123", 16).to_bytes(20, "little")
    r = _u256(nt, "12")
    if name == "send":
        pk_sender = int("456", 16).to_bytes(20, "little")
        note_s = nt.NoteS(6, pk_recv, nt.compute_crh(pk_sender, r), sn_old)
        note = nt.Note(4, nt.compute_prf(sk, r), r)
        return (nt.Note(10, sn_old, r_old).cm(), sn_old, note_s.cm(),
                note.cm())
    r_s = _u256(nt, "123")
    note_s = nt.NoteS(9, pk_recv, r_s, _u256(nt, "123"))
    note = nt.Note(264, nt.compute_prf(sk, r), r)
    wit = deposit_tree(nt, mk, instances.CIRCUITS[name], note_s.cm())
    return (wit.root(), pk_recv, nt.Note(255, sn_old, r_old).cm(), sn_old,
            note.cm(), nt.compute_prf(sk, r_s))


def jax_protoboard(name):
    """Circuit `name` built from the JAX package's gadgets, notes and
    Merkle tree, with the values of scripts/witnesses.py."""
    nt = JNT
    sk = _u256(nt, "1")
    r_old = _u256(nt, "123456")
    sn_old = nt.compute_prf(sk, r_old)
    pb = JaxProtoboard()
    if name in ("mint", "redeem"):
        r = _u256(nt, "123")
        v_old, v = (6, 13) if name == "mint" else (13, 6)
        note_old = nt.Note(v_old, sn_old, r_old)
        note = nt.Note(v, nt.compute_prf(sk, r), r)
        g = (JaxMintGadget if name == "mint" else JaxRedeemGadget)(pb)
        g.generate_constraints()
        g.generate_witness(note_old, note, note_old.cm(), note.cm(), 7, sk)
        return pb
    pk_recv = int("123", 16).to_bytes(20, "little")
    r = _u256(nt, "12")
    if name == "send":
        pk_sender = int("456", 16).to_bytes(20, "little")
        note_old = nt.Note(10, sn_old, r_old)
        note = nt.Note(4, nt.compute_prf(sk, r), r)
        note_s = nt.NoteS(6, pk_recv, nt.compute_crh(pk_sender, r), sn_old)
        g = JaxSendGadget(pb)
        g.generate_constraints()
        g.generate_witness(note_old, note_s, note, note_old.cm(),
                           note_s.cm(), note.cm(), sk, pk_sender)
        return pb
    depth = instances.CIRCUITS[name]
    r_s = _u256(nt, "123")
    note_old = nt.Note(255, sn_old, r_old)
    note_s = nt.NoteS(9, pk_recv, r_s, _u256(nt, "123"))
    note = nt.Note(264, nt.compute_prf(sk, r), r)
    wit = deposit_tree(nt, JMK, depth, note_s.cm())
    g = JaxDepositGadget(pb, depth=depth)
    g.generate_constraints()
    g.generate_witness(note_s, note_old, note, note_s.cm(), note_old.cm(),
                       note.cm(), wit.root(), wit.path(),
                       nt.compute_prf(sk, r_s), sk)
    return pb


PORT_GADGETS = {"mint": MintGadget, "send": SendGadget,
                "redeem": RedeemGadget, "deposit": DepositGadget,
                "deposit20": DepositGadget}
JAX_GADGETS = {"mint": JaxMintGadget, "send": JaxSendGadget,
               "redeem": JaxRedeemGadget, "deposit": JaxDepositGadget,
               "deposit20": JaxDepositGadget}


@pytest.mark.parametrize("name", ["mint", "send", "redeem", "deposit",
                                  "deposit20"])
def test_protoboard_equal(name):
    """instances.protoboard(name) against the JAX package's gadgets on the
    same values: variables, input size, every constraint, both inputs and
    satisfaction; the primary input is the circuit's witness_map."""
    pb = instances.protoboard(name)
    jpb = jax_protoboard(name)
    assert pb.num_variables == jpb.num_variables
    assert pb.primary_input_size == jpb.primary_input_size
    assert len(pb.constraints) == len(jpb.constraints)
    if name in NUM_CONSTRAINTS:
        assert len(pb.constraints) == NUM_CONSTRAINTS[name]
    for (a, b, c), (ja, jb, jc) in zip(pb.constraints, jpb.constraints):
        assert (a.as_dict(), b.as_dict(), c.as_dict()) == \
            (ja.as_dict(), jb.as_dict(), jc.as_dict())
    assert pb.primary_input() == jpb.primary_input()
    assert pb.auxiliary_input() == jpb.auxiliary_input()
    assert pb.is_satisfied() and jpb.is_satisfied()
    assert pb.primary_input() == PORT_GADGETS[name].witness_map(
        *public_values(NT, MK, name))


@pytest.mark.parametrize("name", ["mint", "send", "redeem", "deposit",
                                  "deposit20"])
def test_witness_map_equal(name):
    args = public_values(NT, MK, name)
    assert args == public_values(JNT, JMK, name)
    want = JAX_GADGETS[name].witness_map(*args)
    assert PORT_GADGETS[name].witness_map(*args) == want


def test_deposit_wrong_root_rejected():
    """The port's counterpart of tests/test_circuits.py's: the deposit
    instance with a root that is not its tree's is not satisfied."""
    (note_s, note_old, note, cmtS, cmtB_old, cmtB, rt, path, sn_s,
     sk) = instances.deposit_witness()
    pb = Protoboard()
    g = DepositGadget(pb)
    g.generate_constraints()
    g.generate_witness(note_s, note_old, note, cmtS, cmtB_old, cmtB,
                       MK.combine(rt, rt), path, sn_s, sk)
    assert not pb.is_satisfied()


@pytest.mark.parametrize("depth", [8, 20])
def test_merkle_tree_equal(depth):
    """Roots, authentication paths, addresses and empty roots of the port's
    incremental tree equal the JAX package's, for witnesses taken at
    several leaves of a 16-leaf tree."""
    assert MK.DEPTH == JMK.DEPTH == 8
    assert MK.IncrementalMerkleTree.empty_root(depth) == \
        JMK.IncrementalMerkleTree.empty_root(depth)
    leaves = [NT.uint256_from_hex(str(i + 1)) for i in range(16)]
    for at in (0, 5, 9, 15):
        trees = [MK.IncrementalMerkleTree(depth),
                 JMK.IncrementalMerkleTree(depth)]
        wits = [None, None]
        for i, leaf in enumerate(leaves):
            for k in range(2):
                if wits[k] is not None:
                    wits[k].append(leaf)
                else:
                    trees[k].append(leaf)
                if i == at:
                    wits[k] = trees[k].witness()
        paths = [w.path() for w in wits]
        assert wits[0].root() == wits[1].root()
        assert paths[0].authentication_path == paths[1].authentication_path
        assert paths[0].index == paths[1].index
        assert paths[0].address == paths[1].address == at
        assert len(paths[0].authentication_path) == depth
    assert trees[0].root() == trees[1].root()
