"""msm_round's share of its roofline over the traced window: the least
time its work could take on the card (portbench.peaks: one mixed add a
live item, or its bytes), summed over every proof of the window, over the
device time of every accumulate_kernel launch the profiler saw there. An
average over the launches, not a median."""


def read(run):
    if run.trace is None or run.kind != "prove" or not run.work:
        return None
    seconds, launches = run.trace.op_seconds(
        lambda name: "accumulate_kernel" in name)
    if not launches:
        return None
    bound = sum(run.work[rec["slot"]]["bound_s"] for rec in run.records)
    return 100.0 * bound / seconds
