"""Mint (convert public balance into a note): a transaction's plain data
drawn from the traffic's random stream, and the statement it proves."""

from portbench.reference import notes as N

# values stay far below 2^64, so value_old + value_s never overflows
VALUE_BITS = 40


def transaction(rng) -> dict:
    """A mint of value_s onto the note (value_old, r_old) of key sk, whose
    new note is (value_old + value_s, r)."""
    return {"sk": rng.randbytes(32), "r_old": rng.randbytes(32),
            "r": rng.randbytes(32), "value_old": rng.getrandbits(VALUE_BITS),
            "value_s": rng.getrandbits(VALUE_BITS)}


def statement(tx, config) -> list:
    """The public input: cmtA_old, sn_old, cmtA and value_s, packed."""
    sn_old = N.prf(tx["sk"], tx["r_old"])
    cm_old = N.note_cm(tx["value_old"], sn_old, tx["r_old"])
    cm = N.note_cm(tx["value_old"] + tx["value_s"], N.prf(tx["sk"], tx["r"]),
                   tx["r"])
    value_s = tx["value_s"].to_bytes(8, "little")
    return N.pack(N.bits(cm_old) + N.bits(sn_old) + N.bits(cm)
                  + N.bits(value_s))
