"""Peak device memory the program allocated in the window on the fullest
card of the cell's, GiB: each card's peak counter restarts after the
warm-up (the driver, and the harness on the current card)."""

import torch


def read(run):
    if run.window_peak_bytes is None:
        return None
    cards = range(run.spec.workload["chips"])
    return max([run.window_peak_bytes] + [torch.cuda.max_memory_allocated(c) for c in cards]) / 2**30
