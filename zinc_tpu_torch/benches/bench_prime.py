"""Prime generation benchmark of the port: the mirror of
``benches/bench_prime.py`` (itself the mirror of the Rust
``prime_generation_benches.rs:15-23``).

    python -m zinc_tpu_torch.benches.bench_prime

The 256-bit (n64 = 4) Miller-Rabin rejection sampling from transcript bytes
that ``draw_random_field`` runs, ms a prime over 20 transcripts.  The work
is the host's (``prime.get_prime``), so the bench takes no device and its
first line names the host's CPU.
"""

from __future__ import annotations

import sys
import time

from ..prime import get_prime
from ..transcript import KeccakTranscript
from ._common import device_line, emit


def run(iters: int = 20) -> dict:
    t0 = time.perf_counter()
    for i in range(iters):
        t = KeccakTranscript()
        t.absorb(b"prime-bench" + bytes([i]))
        get_prime(t, 4)
    return emit("prime_gen_256bit", (time.perf_counter() - t0) / iters * 1e3, "ms")


def main(argv: list[str]) -> list[dict]:
    if argv[1:]:
        raise SystemExit(f"bench_prime takes no arguments, got {argv[1:]}")
    print(device_line("cpu"), flush=True)
    return [run()]


if __name__ == "__main__":
    main(sys.argv)
