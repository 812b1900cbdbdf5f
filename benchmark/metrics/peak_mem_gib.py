"""Peak device memory the program allocated in the window (the peak
counter reset after the warm-up), GiB."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
