"""The share of the traced window in which no operation ran on the card,
the mean over the cell's cards (1 - busy_s over the window, busy_s each
card's union of operation intervals, averaged over the cards), in a cell
of prove traffic."""


def read(run):
    if run.trace is None or run.kind != "prove" or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
