"""Spartan prover/verifier benchmark of the port: the mirror of
``benches/bench_spartan.py`` (itself the mirror of the Rust
``spartan_benches.rs:24-151``).

    python -m zinc_tpu_torch.benches.bench_spartan [log_n ...] [device]   # 12 14 16, cuda

The dummy R1CS CCS of 2^log_n constraints (seed 42, 62-bit witness), a
256-bit field drawn by Fiat-Shamir, the device prover
(``spartan_dev.spartan_prove_device`` on the statement and z uploaded once)
and the host verifier (``spartan.spartan_verify``).  As in the JAX bench each
is run once warm, then timed on the host clock (the device synced); the
timed proof must verify.  On the CPU the sizes default to 2^8.
"""

from __future__ import annotations

import random
import sys

from ..ccs import dummy_ccs_of_size
from ..prime import draw_random_field
from ..spartan import spartan_verify
from ..fields.integers import int_vector
from ..ops.field_map import vector_to_field
from ..spartan_dev import DeviceStatement, spartan_prove_device
from ..transcript import KeccakTranscript
from ._common import device_line, emit, parse, wall_s


def run(log_n: int, device) -> list[dict]:
    _, ccs, statement, wit = dummy_ccs_of_size(1 << log_n, random.Random(42), int_bits=62)
    cfg = draw_random_field(statement.public_input, KeccakTranscript(), 1, 4)
    z_ccs = statement.get_z_vector(wit.w_ccs)
    if len(z_ccs) <= ccs.m:
        z_ccs = z_ccs + [0] * (ccs.m - len(z_ccs))
    ds = DeviceStatement.upload(cfg, statement, device)
    z_f = vector_to_field(cfg, int_vector(z_ccs), device)

    def prove():
        tp = KeccakTranscript()
        if draw_random_field(statement.public_input, tp, 1, 4) != cfg:
            raise AssertionError("the prover drew another field")
        return spartan_prove_device(ds, z_f, ccs, tp, cfg)[0]

    ccs_f = ccs.map_to_field(cfg)

    def verify():
        tv = KeccakTranscript()
        if draw_random_field(statement.public_input, tv, 1, 4) != cfg:
            raise AssertionError("the verifier drew another field")
        spartan_verify(proof, ccs_f, tv, cfg)

    wall_s(prove, device)
    proof, prove_s = wall_s(prove, device)
    wall_s(verify, device)
    _, verify_s = wall_s(verify, device)
    return [emit(f"spartan_prove_2p{log_n}", prove_s * 1e3, "ms"),
            emit(f"spartan_verify_2p{log_n}", verify_s * 1e3, "ms")]


def main(argv: list[str]) -> list[dict]:
    sizes, device = parse(argv[1:], [12, 14, 16], [8])
    print(device_line(device), flush=True)
    return [rec for log_n in sizes for rec in run(log_n, device)]


if __name__ == "__main__":
    main(sys.argv)
