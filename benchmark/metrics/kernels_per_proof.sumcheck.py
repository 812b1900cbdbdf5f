"""``kernels_per_proof``, read the same way, in the sumcheck cell, where it moves
``prove_p95_s`` (that cell reports no ``prove_s``)."""

from benchmark.harness.spec import module

read = module("metrics", "kernels_per_proof").read
