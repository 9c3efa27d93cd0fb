"""The share of the traced window in which no operation ran on the card
(1 - the union of the device's operation intervals over the window), in
a cell of batch traffic."""


def read(run):
    if run.trace is None or run.kind != "batch" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
