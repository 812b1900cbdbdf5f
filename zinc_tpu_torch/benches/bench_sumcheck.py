"""Sumcheck prove + verify benchmark of the port: the mirror of
``benches/bench_sumcheck.py`` (itself the mirror of the Rust
``sumcheck_benches.rs:17-40``): 2^nv variables, a product of 7 factors,
degree 7, q = 2^255 + 95 (n64 = 4), proved through the executor and checked
by the host verifier.

    python -m zinc_tpu_torch.benches.bench_sumcheck [nv] [device]   # 20, cuda

Prints the device (the card's name and power limit, or ``cpu``), then the
JAX bench's two JSON metric lines.  The tables are random residues made
from a seed with numpy; the claimed sum is the plain PyTorch product and
lazy sum on the device, never the kernels.  As in the JAX bench, the timed
prove is the second one (the first pays the kernel build), and the timed
verify the second.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..fields.config import FieldConfig, Fp
from ..sumcheck.verifier import SumcheckError, verify_as_subprotocol
from ..transcript import KeccakTranscript
from ..fields import montgomery as fm
from ..fields.montgomery import device_field
from ..ops import _cuda
from ..poly.device import limbs_to_fp
from ..sumcheck.executor import make_executor, prove_with_executor
from ._common import device_line, emit, parse_one

N_FACTORS = 7
Q = (1 << 255) + 95


def random_tables(cfg: FieldConfig, nv: int, n: int, seed: int, device) -> torch.Tensor:
    """n tables of 2^nv residues below q: random words, the top one below
    q's top word."""
    ctx = device_field(cfg)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = rng.integers(0, 1 << 32, size=(1 << nv, ctx.n32), dtype=np.uint64).astype(np.uint32)
        words[:, -1] = rng.integers(0, int(ctx.q[-1]), size=1 << nv, dtype=np.uint64).astype(np.uint32)
        out.append(fm.to_tensor(words, device))
    return torch.stack(out)


def claimed_sum(cfg: FieldConfig, tables: torch.Tensor) -> Fp:
    """Σ_x Π_k T_k[x] with the plain field ops on the tables' device."""
    ctx = device_field(cfg)
    prod = tables[0]
    for t in tables[1:]:
        prod = fm.mont_mul(ctx, prod, t)
    return limbs_to_fp(fm.mod_reduce_wide(ctx, fm.lazy_sum(ctx, prod, dim=0)), cfg)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(nv: int, device, seed: int = 0) -> dict:
    """One warm-up prove, then the timed prove and verify; raises unless the
    verifier accepts and its final subclaim equals the product of the final
    values.  ``launches`` are the kernel launches of the timed prove (the
    counts are set to 0 just before it)."""
    cfg = FieldConfig(Q, 4)
    tables = random_tables(cfg, nv, N_FACTORS, seed, device)
    claimed = claimed_sum(cfg, tables)
    comb = [(cfg.one(), tuple(range(N_FACTORS)))]

    def prove():
        ex = make_executor(cfg, tables, N_FACTORS, comb)
        proof, _ = prove_with_executor(KeccakTranscript(), ex, nv, N_FACTORS, cfg)
        _sync(device)
        return proof, ex.final_values()

    prove()
    _sync(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    proof, finals = prove()
    prove_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)

    verify_as_subprotocol(KeccakTranscript(), nv, N_FACTORS, claimed, proof, cfg)
    t0 = time.perf_counter()
    sub = verify_as_subprotocol(KeccakTranscript(), nv, N_FACTORS, claimed, proof, cfg)
    verify_s = time.perf_counter() - t0
    expected = cfg.one()
    for v in finals:
        expected = expected * v
    if not sub.expected_evaluation == expected:
        raise SumcheckError("final subclaim != product of the final values")
    return {"nv": nv, "prove_s": prove_s, "verify_s": verify_s, "accepted": True,
            "launches": launches}


def main(argv: list[str]) -> list[dict]:
    nv, device = parse_one(argv[1:], 20, 20)
    print(device_line(device), flush=True)
    res = run(nv, device)
    return [emit(f"sumcheck_prove_{nv}v_{N_FACTORS}prod", res["prove_s"] * 1e3, "ms"),
            emit(f"sumcheck_verify_{nv}v_{N_FACTORS}prod", res["verify_s"] * 1e3, "ms")]


if __name__ == "__main__":
    main(sys.argv)
