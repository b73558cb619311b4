"""Seconds from the process's start to the window's: imports, CUDA's
start, the kernels' libraries (built on a checkout's first run), the
graph's generation and one warm request at the cell's shapes."""


def read(run):
    return run.setup_s
