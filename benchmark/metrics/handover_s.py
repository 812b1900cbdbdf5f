"""Seconds a prove in the program's ``mesh.handover`` spans: each sharded
sumcheck's blocks joined on the mesh's first card once they hold at most
64 entries; summed inside each traced prove span, mean over the proves."""

from benchmark.harness.program_spans import mean_in_proves


def read(run):
    return mean_in_proves(run, "mesh.handover")
