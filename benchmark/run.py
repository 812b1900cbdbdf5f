"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json``).  It loads, warms up, measures for ``--seconds``
(with ``--trace 1`` under the profiler, reporting the per-layer metrics),
compares what the window produced with the plain reference, prints each
compared number beside its limit on standard error, and prints one JSON
object as the last line of standard output.  Without the cards, or with
JAX loaded in this process, it exits with another code than 0 and prints
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every kernel cache inside the checkout, at fixed paths: the program
    builds into its own ``zinc_tpu_torch/_build``; these catch the rest."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    _caches()

    from benchmark.harness import guard, spec as specs
    from benchmark.harness.runner import run_cell

    spec = specs.load(args.workload)
    why_not = guard.cards(spec.workload["chips"])
    if why_not:
        print(f"benchmark: {why_not}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                      spec=spec)
    found = guard.forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
