"""Seconds a prove in the program's ``prove.zip_open.write`` spans: the
column records and the evaluation row serialized into the PCS
transcript; summed inside each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "prove.zip_open.write")
