"""Seconds from the process's start to the window's first call: the
library, the keys (keygen on a checkout's first run), the program's
construction, the traffic's pool and the warm-up."""


def read(run):
    return run.setup_s
