"""Mean verify wall over the window's verifies: what a verifier pays."""

from benchmark.harness.readout import walls
from benchmark.harness.stats import mean


def read(run):
    return mean(walls(run, "verify"))
