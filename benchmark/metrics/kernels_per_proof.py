"""Device kernels, copies and memsets that start inside a traced prove
span, over the number of traced proves."""

from benchmark.harness.readout import proves


def read(run):
    sp = proves(run)
    if sp is None:
        return None
    return float(run.trace.inside(*sp).sum()) / len(sp[0])
