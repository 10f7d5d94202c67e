"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build or load, the data, the warm-up paths."""

UNIT = "s"


def read(run):
    return run.setup_s
