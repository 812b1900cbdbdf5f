"""The Zinc prover and verifier on the dummy R1CS, closed loop.

Each step proves a fresh instance of 2^log_n constraints and verifies the
proof: z made from (seed, step), so a fresh public input, field and C; A
and B are the same objects all run long, as a fixed circuit's matrices
are.  The prove wall covers the field's drawing and ``ZincProver.prove``,
the verify wall ``ZincVerifier.verify``, each with the card synced at
both ends.
"""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

import zinc_tpu_torch as zt
from zinc_tpu_torch.ccs import Statement, Witness, dummy_ccs_from_z, squaring_matrix
from zinc_tpu_torch.sumcheck.executor import SUMCHECKS
from zinc_tpu_torch.timing import STAGES
from zinc_tpu_torch.zinc import ZincError
from zinc_tpu_torch.zip.code import DefaultLinearCodeSpec

from benchmark.harness.runner import sync
from benchmark.harness.seeds import WARM, rng
from benchmark.harness.trace import span


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, control: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        # the field the program draws: the stated one, or the control's narrower one
        self.n64 = config["control"]["field_n64"] if control else config["field_n64"]
        code = DefaultLinearCodeSpec()
        stated = (code.num_column_opening(), code.repetition_factor())
        if stated != (config["openings"], config["repetition"]):
            raise ValueError(f"the program's code (openings, repetition) {stated} is not the "
                             f"configuration's")
        self.n = 1 << traffic["log_n"]
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
        self.types = zt.ZipTypes(config["int_words"])
        self.ccs, st, _ = dummy_ccs_from_z(self.z(WARM).tolist(), config["public_inputs"])
        self.a, self.b = st.constraints[:2]
        self.prover = zt.ZincProver(self.types, device=device)
        self.verifier = zt.ZincVerifier(self.types, device=device)

    def z(self, step: int) -> np.ndarray:
        bits = self.config["int_bits"]
        z = rng(self.seed, step).integers(-(1 << bits), 1 << bits, size=self.n, dtype=np.int64)
        z[self.config["public_inputs"]] = 1
        return z

    def warm(self) -> None:
        for k in range(self.traffic["warmup_steps"]):
            rec = self.step(WARM + k, self.inputs(WARM + k))
            if rec["error"] or not rec["accepted"]:
                raise RuntimeError(f"warm-up step failed: {rec['error'] or 'proof rejected'}")

    def inputs(self, step: int):
        z = self.z(step).tolist()
        c = squaring_matrix(self.n, self.n, z)
        l = self.config["public_inputs"]
        out = Statement(constraints=[self.a, self.b, c], public_input=z[:l]), Witness(z[l + 1:])
        # the last step's garbage and this step's millions of new objects are
        # collected here, outside the walls, not at some allocation inside one
        gc.collect()
        return out

    def step(self, step: int, inputs) -> dict:
        st, wit = inputs
        SUMCHECKS.clear()
        sync(self.device)
        t0 = time.perf_counter()
        try:
            with span("bench.prove"):
                t = zt.KeccakTranscript()
                cfg = zt.draw_random_field(st.public_input, t, self.types.n_words, self.n64)
                proof = self.prover.prove(st, wit, t, self.ccs, cfg)
                sync(self.device)
        except Exception as e:  # a prover that raises has failed this step
            return {"error": repr(e)}
        t1 = time.perf_counter()
        stages, sumchecks = dict(STAGES), list(SUMCHECKS)
        accepted, error = True, None
        with span("bench.verify"):
            try:
                self.verifier.verify(st, proof, zt.KeccakTranscript(), self.ccs, cfg)
            except ZincError:
                accepted = False
            except Exception as e:
                accepted, error = False, repr(e)
            sync(self.device)
        t2 = time.perf_counter()
        stages.update((k, v) for k, v in STAGES.items() if k.startswith("verify."))
        return {"error": error, "accepted": accepted, "walls": {"prove": t1 - t0, "verify": t2 - t1},
                "stages": stages, "sumchecks": sumchecks, "output": (cfg.q, proof)}

    @staticmethod
    def plain(output) -> dict:
        q, proof = output
        sp, zp = proof.spartan_proof, proof.zip_proof
        return {"q": q, "sc1": [[e.m for e in r] for r in sp.linearization_sumcheck],
                "sc2": [[e.m for e in r] for r in sp.second_sumcheck],
                "v_s": [v.m for v in sp.V_s], "v": zp.v.m, "roots": list(zp.z_comm.roots),
                "pcs": zp.pcs_proof}

    def close(self) -> None:
        del self.prover, self.verifier, self.a, self.b
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def check(self, kept: dict, steps: list[dict]) -> dict:
        """The kept steps in full (the program's verifier judged every step)."""
        totals = dict.fromkeys(self.reference.NUMBERS, 0)
        for step, proof in sorted(kept.items()):
            for k, v in self.reference.check(self.z(step), proof, self.config).items():
                totals[k] += v
        return {k: (v, self.config["limits"][k]) for k, v in totals.items()}
