"""Transactions synthesised, proved and verified in the window, over the
window's seconds."""


def read(run):
    if run.kind != "tx" or not run.records:
        return None
    return len(run.records) / run.window_s
