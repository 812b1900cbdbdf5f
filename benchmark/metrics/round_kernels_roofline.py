"""The sumcheck's least device time over the device time of the kernels
its proves launched, in percent.  The least time comes from the shape
alone (tables, entries, products, points, field words) and the card's
maximum SM clock, by ``harness.roofline``: it is the same whatever kernels
run.  A round's polynomial of degree d needs d points a prover computes
(p(1) is the claim less p(0)).  The measured time is every kernel that
starts inside a traced prove span, a prove's mean."""

from benchmark.harness.readout import proves
from benchmark.harness.roofline import sumcheck_least_ms
from benchmark.reference.sumcheck_product import terms


def read(run):
    sp = proves(run)
    cfg = run.spec.config
    if sp is None or run.card is None or "factors_per_product" not in cfg:
        return None
    tr = run.trace
    mask = tr.inside(*sp) & tr.dev_kernel
    kernel_ms = float((tr.dev_end[mask] - tr.dev_start[mask]).sum()) / 1e3 / len(sp[0])
    if kernel_ms <= 0:
        return None
    products = terms(cfg)
    least = sumcheck_least_ms(run.spec.traffic["log_n"], sum(map(len, products)), products,
                              cfg["degree"], 2 * cfg["field_n64"], run.card["max_sm_mhz"])
    return 100.0 * least / kernel_ms
