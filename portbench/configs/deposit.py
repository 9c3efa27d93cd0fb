"""Deposit on the port: the circuit at the configuration's Merkle depth and
a transaction's witness as the service synthesises it."""

from blockmaze_tpu_torch.circuits import instances
from blockmaze_tpu_torch.circuits.deposit import DepositGadget
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.merkle import incremental as MK
from blockmaze_tpu_torch.r1cs.protoboard import Protoboard

CIRCUIT = "deposit"


def protoboard():
    """The circuit with its constraints, for keygen."""
    return instances.protoboard(CIRCUIT)


def witness(tx, config):
    """(primary, aux) of the transaction, the witness alone: the tree of
    its commitments built, the transfer note's path taken from it."""
    depth = config["merkle_depth"]
    sk, r_old, r, r_s = tx["sk"], tx["r_old"], tx["r"], tx["r_s"]
    note_old = NT.Note(tx["value_old"], NT.compute_prf(sk, r_old), r_old)
    note = NT.Note(tx["value_old"] + tx["value_s"], NT.compute_prf(sk, r), r)
    note_s = NT.NoteS(tx["value_s"], tx["pk_recv"], r_s, tx["sn_s_old"])
    cm_s = note_s.cm()
    leaves = list(tx["leaves"])
    leaves.insert(tx["index"], cm_s)
    tree = MK.IncrementalMerkleTree(depth)
    wit = None
    for k, leaf in enumerate(leaves):
        if wit is not None:
            wit.append(leaf)
        else:
            tree.append(leaf)
        if k == tx["index"]:
            wit = tree.witness()
    pb = Protoboard()
    DepositGadget(pb, depth=depth).generate_witness(
        note_s, note_old, note, cm_s, note_old.cm(), note.cm(), wit.root(),
        wit.path(), NT.compute_prf(sk, r_s), sk)
    return pb.primary_input(), pb.auxiliary_input()
