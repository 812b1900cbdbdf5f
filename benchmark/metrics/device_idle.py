"""Share of the prove walls in which the device ran nothing: 1 minus the
union of kernels, copies and memsets inside the traced prove spans over
the spans' sum, in percent."""

from benchmark.harness.readout import device_busy_in_proves


def read(run):
    got = device_busy_in_proves(run)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * (1.0 - got[0] / got[1])
