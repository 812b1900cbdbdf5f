"""Seconds a prove in the program's ``prove.upload.coo`` spans: the Python
walk of each matrix's rows into COO arrays (``SparseMatrix.packed_coo``,
memoized: each step's fresh C); summed inside each traced prove span,
mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "prove.upload.coo")
