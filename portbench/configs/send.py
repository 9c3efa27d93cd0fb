"""Send on the port: the circuit and a transaction's witness as the
service synthesises it (zktx.go GenSendProof, sn_old = PRF(sk, r_old))."""

from blockmaze_tpu_torch.circuits import instances
from blockmaze_tpu_torch.circuits.send import SendGadget
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.r1cs.protoboard import Protoboard

CIRCUIT = "send"


def protoboard():
    """The circuit with its constraints, for keygen."""
    return instances.protoboard(CIRCUIT)


def witness(tx, config):
    """(primary, aux) of the transaction, the witness alone. The payer's
    new value is value_old - value_s in 64-bit arithmetic, as the wallet's
    uint64 computes it: a value_s above value_old wraps, and the circuit
    then rejects the witness."""
    sk, r_old, r = tx["sk"], tx["r_old"], tx["r"]
    sn_old = NT.compute_prf(sk, r_old)
    note_old = NT.Note(tx["value_old"], sn_old, r_old)
    note = NT.Note((tx["value_old"] - tx["value_s"]) % (1 << 64),
                   NT.compute_prf(sk, r), r)
    note_s = NT.NoteS(tx["value_s"], tx["pk_recv"],
                      NT.compute_crh(tx["pk_sender"], r), sn_old)
    pb = Protoboard()
    SendGadget(pb).generate_witness(note_old, note_s, note, note_old.cm(),
                                    note_s.cm(), note.cm(), sk,
                                    tx["pk_sender"])
    return pb.primary_input(), pb.auxiliary_input()
