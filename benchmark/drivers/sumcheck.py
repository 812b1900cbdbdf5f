"""A standalone sumcheck of Σ_x Σ_j c_j · Π_{k∈P_j} T_k(x) through the
per-round driver (``sumcheck.device.prove_as_subprotocol_device``), closed
loop.

Each step proves over fresh tables made on the card from (seed, step):
random residues below q (random 32-bit words, the top one below q's), in
the program's form, int32 words of Montgomery residues; and over fresh
coefficients c_j below q.  Each product P_j has tables of its own
(``reference.sumcheck_product.terms``).  Each step's transcript first
absorbs the step index (8 bytes, little-endian), so no two proofs are
alike.  The wall covers the transcript's creation and the prove, the card
synced at both ends.
"""

from __future__ import annotations

import gc
import importlib
import random
import time

import numpy as np
import torch

from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.sumcheck.device import prove_as_subprotocol_device
from zinc_tpu_torch.sumcheck.executor import SUMCHECKS
from zinc_tpu_torch.transcript import KeccakTranscript

from benchmark.harness.runner import sync
from benchmark.harness.seeds import WARM, seed64
from benchmark.harness.trace import span


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, control: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.stated = FieldConfig(config["modulus"], config["field_n64"])
        # the field the program runs in: the stated one, or the control's narrower one
        low = config["control"]
        self.cfg = FieldConfig(low["modulus"], low["field_n64"]) if control else self.stated
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
        self.terms = self.reference.terms(config)
        self.k, self.degree = sum(map(len, self.terms)), config["degree"]
        self.log_n = traffic["log_n"]

    def tables(self, step: int, cfg: FieldConfig | None = None) -> torch.Tensor:
        """(k, 2^log_n, 2·n64) int32 words of residues below the stated q;
        for a narrower ``cfg``, their low words, the top one reduced below
        that q's top word."""
        q, n32 = self.stated.q, 2 * self.stated.n64
        nq = -(-q.bit_length() // 32)  # the words a residue below q takes
        g = torch.Generator(device=self.device).manual_seed(seed64(self.seed, step))
        shape = (self.k, 1 << self.log_n)
        w = torch.randint(0, 1 << 32, shape + (nq,), generator=g, device=self.device,
                          dtype=torch.int64)
        w[..., -1] = torch.randint(0, q >> (32 * (nq - 1)), shape, generator=g,
                                   device=self.device, dtype=torch.int64)
        if cfg is not None and cfg.n64 < self.stated.n64:
            w = w[..., :2 * cfg.n64].clone()
            w[..., -1] %= cfg.q >> (64 * cfg.n64 - 32)
        else:
            w = torch.nn.functional.pad(w, (0, n32 - nq))
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    def coeffs(self, step: int) -> list[int]:
        """The products' coefficients, canonical, below the stated q."""
        rng = random.Random(f"{self.seed}:{step}:coefficients")
        return [rng.randrange(self.stated.q) for _ in self.terms]

    def warm(self) -> None:
        for k in range(self.traffic["warmup_steps"]):
            rec = self.step(WARM + k, self.inputs(WARM + k))
            if rec["error"]:
                raise RuntimeError(f"warm-up step failed: {rec['error']}")

    def inputs(self, step: int):
        tables = self.tables(step, self.cfg)
        comb = [(self.cfg.fp(c), t) for c, t in zip(self.coeffs(step), self.terms)]
        sync(self.device)
        return tables, comb

    def step(self, step: int, inputs) -> dict:
        tables, comb = inputs
        SUMCHECKS.clear()
        sync(self.device)
        t0 = time.perf_counter()
        try:
            with span("bench.prove"):
                t = KeccakTranscript()
                t.absorb(step.to_bytes(8, "little"))
                out = prove_as_subprotocol_device(t, self.cfg, tables, self.log_n, self.degree,
                                                  comb)
                sync(self.device)
        except Exception as e:  # a prover that raises has failed this step
            return {"error": repr(e)}
        return {"error": None, "walls": {"prove": time.perf_counter() - t0}, "stages": {},
                "sumchecks": list(SUMCHECKS), "output": out, "trail": self.plain(out)}

    @staticmethod
    def plain(output) -> dict:
        proof, randomness, finals = output
        return {"evals": [[e.m for e in r] for r in proof],
                "challenges": [r.m for r in randomness], "finals": [v.m for v in finals]}

    def close(self) -> None:
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference_tables(self, step: int) -> list[np.ndarray]:
        """The step's tables as the reference reads them: Python ints."""
        words = self.tables(step).cpu().numpy().view(np.uint64)  # little-endian word pairs
        out = []
        for tab in words:
            v = tab[:, 0].astype(object)
            for j in range(1, tab.shape[1]):
                v = v + (tab[:, j].astype(object) << (64 * j))
            out.append(v)
        return out

    def check(self, kept: dict, steps: list[dict]) -> dict:
        """The kept steps in full; every step's rounds by ``chains``, a step
        whose chain breaks marked as not accepted."""
        totals = dict.fromkeys(self.reference.NUMBERS, 0)
        for step, proof in sorted(kept.items()):
            tabs = self.reference_tables(step)
            for k, v in self.reference.check(tabs, step, proof, self.config,
                                             self.coeffs(step)).items():
                totals[k] += v
        done = [i for i, s in enumerate(steps) if not s["error"]]
        ok = self.reference.chains(done, [steps[i]["trail"] for i in done],
                                   [self.coeffs(i) for i in done], self.config, self.log_n)
        for i, good in zip(done, ok):
            steps[i]["accepted"] = good
        totals["chains"] = len(done) - sum(ok)
        return {k: (v, self.config["limits"][k]) for k, v in totals.items()}
