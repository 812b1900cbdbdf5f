"""Seconds a prove in the program's ``prove.zip_open.fetch`` spans: the
gathers of the opened columns and Merkle siblings and their copy to the
host; summed inside each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "prove.zip_open.fetch")
