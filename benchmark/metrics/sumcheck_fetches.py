"""Host fetches a prove makes in its sumchecks: the program's
``sumcheck.executor.SUMCHECKS`` counts, summed over a prove's sumchecks,
mean over the window's proves."""

from benchmark.harness.stats import mean


def read(run):
    return mean(sum(sc["fetches"] for sc in s["sumchecks"]) for s in run.completed
                if s["sumchecks"])
