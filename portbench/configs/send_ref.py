"""Send (pay a transfer note out of one's own note): a transaction's plain
data drawn from the traffic's random stream, and the statement it proves.

Follows the reference's GenSendProof (sendcgo.cpp) and its circuit
(send/circuit/gadget.tcc): the transfer note's r_s is the CRH of the
sender's address and the new note's r (send/util.h Compute_CRH), the
transfer note carries the old note's serial number, and the payer keeps
value_old - value_s under a new note.
"""

from portbench.reference import notes as N

# values stay far below 2^64
VALUE_BITS = 40


def crh(pk: bytes, r: bytes) -> bytes:
    """Compute_CRH(pk, r) = SHA256(pk || r) over a 20-byte address and a
    32-byte r."""
    if len(pk) != 20 or len(r) != 32:
        raise ValueError(f"CRH takes a 20-byte pk and a 32-byte r, "
                         f"not {len(pk)} and {len(r)}")
    return N.sha256(pk + r)


def transaction(rng) -> dict:
    """A send of value_s to pk_recv out of the note (value_old, r_old) of
    key sk, whose new note is (value_old - value_s, r). The circuit holds
    value_s <= value_old (less_cmp.tcc, bug-compatible), so value_s is
    drawn from [0, value_old], both ends included."""
    tx = {"sk": rng.randbytes(32), "r_old": rng.randbytes(32),
          "r": rng.randbytes(32), "pk_sender": rng.randbytes(20),
          "pk_recv": rng.randbytes(20),
          "value_old": rng.getrandbits(VALUE_BITS)}
    tx["value_s"] = rng.randrange(tx["value_old"] + 1)
    return tx


def statement(tx, config) -> list:
    """The public input: cmtA_old, sn_old, cmtS and cmtA, packed."""
    sn_old = N.prf(tx["sk"], tx["r_old"])
    cm_old = N.note_cm(tx["value_old"], sn_old, tx["r_old"])
    r_s = crh(tx["pk_sender"], tx["r"])
    cm_s = N.note_s_cm(tx["value_s"], tx["pk_recv"], r_s, sn_old)
    cm = N.note_cm(tx["value_old"] - tx["value_s"], N.prf(tx["sk"], tx["r"]),
                   tx["r"])
    return N.pack(N.bits(cm_old) + N.bits(sn_old) + N.bits(cm_s)
                  + N.bits(cm))
