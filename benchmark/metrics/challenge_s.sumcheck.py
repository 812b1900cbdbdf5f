"""Seconds a prove in the program's ``sumcheck.challenge`` spans: the per-
round driver's transcript absorb and squeeze of each round; summed
inside each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "sumcheck.challenge")
