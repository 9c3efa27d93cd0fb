"""Seconds a transaction's proof call spends synthesising the witness (the
span zktx.witness: the protoboard, the gadget's witness, its primary and
auxiliary inputs), a mean over the window's transactions."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "tx", {"zktx.witness"}, scale=1.0)
