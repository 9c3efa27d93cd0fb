"""Deterministic witness instances of the four circuits, the witness alone:
each function allocates its gadget's variables on a fresh Protoboard and
calls generate_witness only, with no generate_constraints, as the JAX
package's scripts/witnesses.py does for bench.py. A protoboard built here
has no constraints; circuits/instances.py builds the same instances with
their constraints (keygen, the service, chip_smoke.py) and gives the same
primary and auxiliary inputs.

Values mirror the reference's standalone test binaries (hardcoded
sk="1", r_old="123456", deposit values 255/264/9 — src/deposit/main.cpp:131-151,
src/mint/main.cpp) so constraint counts and oracle acceptance are comparable.
"""

from ..crypto import notes as NT
from ..merkle import incremental as MK
from ..r1cs.protoboard import Protoboard
from .mint import MintGadget
from .send import SendGadget
from .redeem import RedeemGadget
from .deposit import DepositGadget


def _u256(h):
    return NT.uint256_from_hex(h)


def witness_mint():
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("123")
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(6, sn_old, r_old)
    note = NT.Note(13, NT.compute_prf(sk, r), r)
    pb = Protoboard()
    MintGadget(pb).generate_witness(note_old, note, note_old.cm(), note.cm(),
                                    7, sk)
    return pb


def witness_send():
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("12")
    pk_sender = int("456", 16).to_bytes(20, "little")
    pk_recv = int("123", 16).to_bytes(20, "little")
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(10, sn_old, r_old)
    note = NT.Note(4, NT.compute_prf(sk, r), r)
    note_s = NT.NoteS(6, pk_recv, NT.compute_crh(pk_sender, r), sn_old)
    pb = Protoboard()
    SendGadget(pb).generate_witness(note_old, note_s, note, note_old.cm(),
                                    note_s.cm(), note.cm(), sk, pk_sender)
    return pb


def witness_redeem():
    sk, r_old, r = _u256("1"), _u256("123456"), _u256("123")
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(13, sn_old, r_old)
    note = NT.Note(6, NT.compute_prf(sk, r), r)
    pb = Protoboard()
    RedeemGadget(pb).generate_witness(note_old, note, note_old.cm(),
                                      note.cm(), 7, sk)
    return pb


def witness_deposit():
    sk = _u256("1")
    r_old, r, r_s = _u256("123456"), _u256("12"), _u256("123")
    pk_recv = int("123", 16).to_bytes(20, "little")
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(255, sn_old, r_old)
    note_s = NT.NoteS(9, pk_recv, r_s, _u256("123"))
    note = NT.Note(264, NT.compute_prf(sk, r), r)
    sn_s = NT.compute_prf(sk, r_s)
    cmtS = note_s.cm()
    leaf_index = 9
    leaves = [cmtS if i == leaf_index else _u256(str(i + 1))
              for i in range(16)]
    tree = MK.IncrementalMerkleTree()
    wit = None
    for i, leaf in enumerate(leaves):
        if wit is not None:
            wit.append(leaf)
        else:
            tree.append(leaf)
        if i == leaf_index:
            wit = tree.witness()
    pb = Protoboard()
    DepositGadget(pb).generate_witness(
        note_s, note_old, note, cmtS, note_old.cm(), note.cm(),
        wit.root(), wit.path(), sn_s, sk)
    return pb


WITNESS = {"mint": witness_mint, "send": witness_send,
           "redeem": witness_redeem, "deposit": witness_deposit}
