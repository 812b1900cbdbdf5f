"""Seconds a prove in the program's ``mesh.scatter`` spans: the tables and
z cut onto the mesh's cards (host time to queue the copies); summed inside
each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "mesh.scatter")
