"""Seconds a prove in the program's ``sumcheck.host_tail`` spans: each
sumcheck's rounds on the host, once its tables hold at most 64 entries;
summed inside each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "sumcheck.host_tail")
