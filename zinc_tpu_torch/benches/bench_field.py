"""Field-arithmetic microbenchmarks of the port: the mirror of
``benches/bench_field.py`` (itself the mirror of the Rust
``random_field_benches.rs:19-97``).

    python -m zinc_tpu_torch.benches.bench_field [log_n] [device]   # 20, cuda

Host: ``mul``, ``add``, ``div`` and ``neg`` of the port's ``Fp`` over the
128-bit prime 2^128 − 159, ns an operation over 10,000.  Batched, at 2^log_n
elements of q = 2^255 + 95 (n64 = 4): the plain ``mont_add`` and
``mont_mul`` of ``fields/montgomery.py`` and, on the card only, K1 through
``ops/field_kernels.mont_mul`` (the JAX bench's ``pallas`` row is ``cuda``
here).  Each batched op is timed per call: device-only on the card
(``bench_kernels.device_ms``; a plain op issues hundreds of torch ops, so
its calls are timed one at a time behind the hold), the host clock on the
CPU.  The kernel's output is first held equal to the plain ``mont_mul``'s.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from ..fields import montgomery as fm
from ..fields.config import FieldConfig
from ..ops import field_kernels
from ._common import call_ms, device_line, emit, is_cuda, parse_one
from .bench_kernels import random_residues

P128 = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF61  # 128-bit prime (2^128 - 159)
Q = (1 << 255) + 95


def host_ubench(n: int = 10_000) -> list[dict]:
    cfg = FieldConfig(P128, 2)
    rng = random.Random(0)
    a = cfg.fp(rng.randrange(cfg.q))
    b = cfg.fp(rng.randrange(cfg.q))
    out = []
    for name, op in [("mul", lambda: a * b), ("add", lambda: a + b),
                     ("div", lambda: a / b), ("neg", lambda: -a)]:
        t0 = time.perf_counter()
        for _ in range(n):
            op()
        out.append(emit(f"host_fp_{name}_128bit", (time.perf_counter() - t0) / n * 1e9, "ns"))
    return out


def device_batch_bench(log_n: int, device) -> list[dict]:
    ctx = fm.device_field(FieldConfig(Q, 4))
    b = 1 << log_n
    rng = np.random.default_rng(0)
    x = random_residues(rng, ctx, (b,), device)
    y = random_residues(rng, ctx, (b,), device)
    ops = {"mont_add": (lambda: fm.mont_add(ctx, x, y), 1),
           "mont_mul": (lambda: fm.mont_mul(ctx, x, y), 1)}
    if is_cuda(device):
        if not torch.equal(field_kernels.mont_mul(ctx, x, y), fm.mont_mul(ctx, x, y)):
            raise AssertionError("K1 differs from the plain mont_mul")
        ops["mont_mul_cuda"] = (lambda: field_kernels.mont_mul(ctx, x, y), 20)
    out = []
    for name, (op, calls) in ops.items():
        ms = call_ms(op, device, calls)
        out.append(emit(f"device_{name}_2p{log_n}", ms, "ms", throughput_meps=b / ms / 1e3))
    return out


def main(argv: list[str]) -> list[dict]:
    log_n, device = parse_one(argv[1:], 20, 16)
    print(device_line(device), flush=True)
    return host_ubench() + device_batch_bench(log_n, device)


if __name__ == "__main__":
    main(sys.argv)
