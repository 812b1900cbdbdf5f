"""Mean prove wall over the window's proves, read per layer in the cells
where ``prove_s`` is not end to end: in the sumcheck cell the host's own
speed moves the mean of a window between runs by more than the widest
bound allowed (PERF.md), and the tail ``prove_p95_s`` stands there."""

from benchmark.harness.readout import walls
from benchmark.harness.stats import mean


def read(run):
    return mean(walls(run, "prove"))
