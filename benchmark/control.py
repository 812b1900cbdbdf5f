"""The control of a cell's comparison: the program run at the next
precision down (the configuration's ``control`` settings), judged by the
same comparison as the benchmark's runs, on several seeds.  Every reading
must come out not correct.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

Prints each seed's compared numbers and one JSON line per seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard, spec as specs
    from benchmark.harness.runner import run_cell

    spec = specs.load(args.workload)
    why_not = guard.cards(spec.workload["chips"])
    if why_not:
        print(f"control: {why_not}", file=sys.stderr)
        return 3
    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(args.workload, seed, args.seconds, False, "cuda", time.perf_counter(),
                       spec=spec, control=True)
        wrong += not res["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "checks": res["checks"]}), flush=True)
    print(f"control: {wrong} of {len(args.seeds.split(','))} seeds not correct", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
