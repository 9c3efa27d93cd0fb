"""Milliseconds a transaction spends in the interpreter's garbage
collector (the spans host.gc inside zktx.prove and zktx.verify requests),
a mean over the window's transactions."""

from portbench import spantree


def read(run):
    return spantree.per_request(run, "tx", {"host.gc"})
