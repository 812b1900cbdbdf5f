"""MB a prove copies between the mesh's cards: the program's
``parallel.mesh.MESH`` bytes (the scatter, the rounds' sums and r, the
hand-over, the gathers), reset at each prove's start; mean over the
window's proves.  None where the program keeps no such count."""

from benchmark.harness.stats import mean


def read(run):
    return mean(s["mesh"]["bytes"] / 1e6 for s in run.completed if s.get("mesh") is not None)
