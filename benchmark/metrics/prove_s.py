"""Mean prove wall over the proves completed in the window (host clock, the
card synced at both ends): what a prover pays for a statement."""

from benchmark.harness.readout import walls
from benchmark.harness.stats import mean


def read(run):
    return mean(walls(run, "prove"))
