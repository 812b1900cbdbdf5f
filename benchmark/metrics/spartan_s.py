"""Mean over the window's steps of the program's ``prove.spartan`` stage wall."""

from benchmark.harness.readout import stage_mean


def read(run):
    return stage_mean(run, "prove.spartan")
