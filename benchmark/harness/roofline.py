"""The yardstick of the card: its peaks, and the least time a sumcheck's
shape needs on it, whatever kernels form it.

A frozen copy of the bound of ``bench_kernels.py``: one NVIDIA H100 SXM
moves 3.35 TB/s from HBM, and each of its 132 SMs issues 64 IMAD slots a
clock; a Montgomery product of N 32-bit words takes 4N² + 2N slots, an
unreduced one 2N².  A call's bound is the slower of its bytes (each input
read once, each output written once) and its products.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_SLOTS_PER_CLOCK = 64


def bound_ms(n32: int, n_bytes: int, full: int, lazy: int, max_sm_mhz: float) -> float:
    clock = SMS * max_sm_mhz * 1e6 / 1e3  # SM clocks a ms
    mem = n_bytes / HBM_BYTES_PER_S * 1e3
    ops = (full * (4 * n32 * n32 + 2 * n32) + lazy * 2 * n32 * n32) / (IMAD_SLOTS_PER_CLOCK * clock)
    return max(mem, ops)


def round_products(pairs: int, terms, n_pts: int) -> tuple[int, int]:
    """(Montgomery, unreduced) products of a round's evaluation at the
    ``n_pts`` points a prover computes: a term of k ≥ 2 factors is a
    polynomial of degree k, so min(k + 1, n_pts) of its values fix it there,
    each with k − 2 Montgomery products and one unreduced one (the sums are
    only needed mod q); a term of one factor needs none."""
    full = lazy = 0
    for t in terms:
        k, pts = len(t), min(len(t) + 1, n_pts)
        if k >= 2:
            lazy += pts
            full += pts * (k - 2)
    return pairs * full, pairs * lazy


def sumcheck_least_ms(log_n: int, n_tables: int, terms, n_pts: int, n32: int,
                      max_sm_mhz: float) -> float:
    """The least device time of a whole sumcheck over ``n_tables`` tables of
    2^log_n entries.  Its rounds run one after another (a round needs the
    last one's challenge), so the bound is the sum of the rounds': round 1
    reads every table and evaluates 2^(log_n − 1) pairs; each later round
    folds its tables (a product an entry kept, the folded half written)
    and evaluates the folded pairs."""
    eb = 4 * n32
    n = 1 << log_n
    full, lazy = round_products(n // 2, terms, n_pts)
    total = bound_ms(n32, n_tables * n * eb, full, lazy, max_sm_mhz)
    b = n
    while b >= 4:
        full, lazy = round_products(b // 4, terms, n_pts)
        total += bound_ms(n32, n_tables * (b + b // 2) * eb, n_tables * b // 2 + full, lazy,
                          max_sm_mhz)
        b //= 2
    return total
