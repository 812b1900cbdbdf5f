"""95th percentile (nearest rank) of every prove wall in the window."""

from benchmark.harness.readout import walls
from benchmark.harness.stats import percentile


def read(run):
    return percentile(walls(run, "prove"), 95)
