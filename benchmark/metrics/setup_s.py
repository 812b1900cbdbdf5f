"""Seconds from the process's start to the window's: imports, the card's
start, the inputs' fixed parts, the warm-up steps, and in a checkout's
first run the kernels' build."""


def read(run):
    return run.setup_s
