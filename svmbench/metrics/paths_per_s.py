"""Cross-validated paths finished per second: the paths over the time from
the window's start to the end of the last path (host clock; every path
ends on the host copy of its result)."""

UNIT = "paths/s"


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    return len(run.records) / run.window_s
