"""The most device memory allocated during the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start:
the data, the fold, and whatever the port holds)."""

UNIT = "GiB"


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
