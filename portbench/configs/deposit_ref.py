"""Deposit (take a transfer note into one's own note, proving it is in the
Merkle tree of commitments): a transaction's plain data drawn from the
traffic's random stream, and the statement it proves."""

from portbench.reference import notes as N

VALUE_BITS = 40
# commitments in the tree, the transfer note's among them
LEAVES = 16


def transaction(rng) -> dict:
    """A deposit of the transfer note (value_s, pk_recv, r_s, sn_s_old),
    found at leaf `index` of a tree of LEAVES commitments, onto the note
    (value_old, r_old) of key sk, whose new note is (value_old + value_s,
    r)."""
    return {"sk": rng.randbytes(32), "r_old": rng.randbytes(32),
            "r": rng.randbytes(32), "r_s": rng.randbytes(32),
            "sn_s_old": rng.randbytes(32), "pk_recv": rng.randbytes(20),
            "value_old": rng.getrandbits(VALUE_BITS),
            "value_s": rng.getrandbits(VALUE_BITS),
            "leaves": [rng.randbytes(32) for _ in range(LEAVES - 1)],
            "index": rng.randrange(LEAVES)}


def leaves(tx) -> list:
    """The tree's commitments in order, the transfer note's at its index."""
    cm_s = N.note_s_cm(tx["value_s"], tx["pk_recv"], tx["r_s"],
                       tx["sn_s_old"])
    out = list(tx["leaves"])
    out.insert(tx["index"], cm_s)
    return out


def statement(tx, config) -> list:
    """The public input: the tree's root, pk_recv, cmtB_old, sn_old, cmtB
    and sn_s, packed."""
    sn_old = N.prf(tx["sk"], tx["r_old"])
    cm_old = N.note_cm(tx["value_old"], sn_old, tx["r_old"])
    cm = N.note_cm(tx["value_old"] + tx["value_s"], N.prf(tx["sk"], tx["r"]),
                   tx["r"])
    root = N.merkle_root(leaves(tx), config["merkle_depth"])
    return N.pack(N.bits(root) + N.bits(tx["pk_recv"]) + N.bits(cm_old)
                  + N.bits(sn_old) + N.bits(cm)
                  + N.bits(N.prf(tx["sk"], tx["r_s"])))
