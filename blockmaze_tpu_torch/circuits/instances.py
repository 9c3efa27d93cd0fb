"""Deterministic instances of the four circuits, each a Protoboard with its
constraints generated and its witness set.

The values are those of the reference's standalone test binaries (sk = 1,
r_old = 123456; deposit values 255 / 264 / 9, src/deposit/main.cpp:131-151,
src/mint/main.cpp), the same as the JAX package's scripts/witnesses.py, so
constraint counts and proofs are comparable across the two packages.
Deposit takes its Merkle depth: 8 (the reference default) or 20 (the
production setting); at either depth the note sits at leaf 9 of a 16-leaf
tree.

    pb = instances.protoboard("deposit20")
"""

from __future__ import annotations

from ..crypto import notes as NT
from ..merkle import incremental as MK
from ..r1cs.protoboard import Protoboard
from .deposit import DepositGadget
from .mint import MintGadget
from .redeem import RedeemGadget
from .send import SendGadget

# circuit name -> Merkle depth of its deposit (None: not a deposit)
CIRCUITS = {"mint": None, "send": None, "redeem": None, "deposit": MK.DEPTH,
            "deposit20": 20}


def _u256(h):
    return NT.uint256_from_hex(h)


def _synthesise(gadget_cls, *args, **kwargs):
    pb = Protoboard()
    g = gadget_cls(pb, **kwargs)
    g.generate_constraints()
    g.generate_witness(*args)
    return pb


def mint() -> Protoboard:
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("123")
    note_old = NT.Note(6, NT.compute_prf(sk, r_old), r_old)
    note = NT.Note(13, NT.compute_prf(sk, r), r)
    return _synthesise(MintGadget, note_old, note, note_old.cm(), note.cm(),
                       7, sk)


def send() -> Protoboard:
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("12")
    pk_sender = int("456", 16).to_bytes(20, "little")
    pk_recv = int("123", 16).to_bytes(20, "little")
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(10, sn_old, r_old)
    note = NT.Note(4, NT.compute_prf(sk, r), r)
    note_s = NT.NoteS(6, pk_recv, NT.compute_crh(pk_sender, r), sn_old)
    return _synthesise(SendGadget, note_old, note_s, note, note_old.cm(),
                       note_s.cm(), note.cm(), sk, pk_sender)


def redeem() -> Protoboard:
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("123")
    note_old = NT.Note(13, NT.compute_prf(sk, r_old), r_old)
    note = NT.Note(6, NT.compute_prf(sk, r), r)
    return _synthesise(RedeemGadget, note_old, note, note_old.cm(),
                       note.cm(), 7, sk)


def deposit_witness(depth: int = MK.DEPTH):
    """The arguments of DepositGadget.generate_witness for the deposit
    instance at Merkle depth `depth`: (note_s, note_old, note, cmtS,
    cmtB_old, cmtB, rt, path, sn_s, sk)."""
    sk = _u256("1")
    r_old, r, r_s = _u256("123456"), _u256("12"), _u256("123")
    pk_recv = int("123", 16).to_bytes(20, "little")
    note_old = NT.Note(255, NT.compute_prf(sk, r_old), r_old)
    note_s = NT.NoteS(9, pk_recv, r_s, _u256("123"))
    note = NT.Note(264, NT.compute_prf(sk, r), r)
    cmtS = note_s.cm()
    leaf_index = 9
    tree = MK.IncrementalMerkleTree(depth)
    wit = None
    for i in range(16):
        leaf = cmtS if i == leaf_index else _u256(str(i + 1))
        if wit is not None:
            wit.append(leaf)
        else:
            tree.append(leaf)
        if i == leaf_index:
            wit = tree.witness()
    return (note_s, note_old, note, cmtS, note_old.cm(), note.cm(),
            wit.root(), wit.path(), NT.compute_prf(sk, r_s), sk)


def deposit(depth: int = MK.DEPTH) -> Protoboard:
    return _synthesise(DepositGadget, *deposit_witness(depth), depth=depth)


def protoboard(name: str) -> Protoboard:
    """The instance of circuit `name` (a key of CIRCUITS)."""
    depth = CIRCUITS[name]
    if depth is not None:
        return deposit(depth)
    return {"mint": mint, "send": send, "redeem": redeem}[name]()
