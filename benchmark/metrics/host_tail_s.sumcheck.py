"""``host_tail_s``, read the same way, in the sumcheck cell, where it moves
``prove_p95_s`` (that cell reports no ``prove_s``): the per-round driver's
hand-over fetch and every host round."""

from benchmark.harness.spec import module

read = module("metrics", "host_tail_s").read
