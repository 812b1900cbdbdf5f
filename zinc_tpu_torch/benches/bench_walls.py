"""The walls of the commit, the eq tables and the sumchecks, for one checkout.

    python3 zinc_tpu_torch/benches/bench_walls.py [--root DIR]

Runs the checkout's bench_zip at 2^12, 2^14 and 2^16, two 2^20 R1CS
proves and verifies (``chip_smoke.prove_verify_large``: stage walls,
launches, the pinned proof's checks) and Spartan's two 2^20 sumchecks under
both drivers in turns (``chip_smoke.compare_drivers``: the device-FS steps,
whose ``start`` builds the Gruen eq levels).  ``--root`` runs another
checkout's port and ``chip_smoke.py`` instead of this one's (as in
``bench_kernels.py``), so that two versions can be compared in one call on
one card, in turns: unpack the other commit with ``git archive`` into a
gitignored directory and run parent, change, change, parent.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose zinc_tpu_torch and chip_smoke.py are run")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_walls needs a CUDA device")
    import chip_smoke as cs
    from zinc_tpu_torch.benches import bench_zip

    cs.log(f"[walls] root {root}: {Path(cs.__file__).resolve()}")
    bench_zip.main(["bench_zip", "12", "14", "16", "cuda"])
    fixture = cs.setup(1 << 20, 5)[:3]
    if hasattr(cs, "tree_kernels"):
        must, must_not = cs.tree_kernels(cs.R1CS_KERNELS, cs.GENERIC_KERNELS, 20)
    else:  # a checkout from before the leaves launch's cluster tail
        must, must_not = cs.with_merges(cs.R1CS_KERNELS, 20), cs.GENERIC_KERNELS
    for i in range(2):
        cs.prove_verify_large(f"walls 2^20 #{i}", fixture, must, must_not)
    cs.compare_drivers("walls R1CS 2^20", fixture, turns=2)


if __name__ == "__main__":
    main()
