"""Undirected input edges of every request completed in the window, in
millions, over the window's seconds (host clock)."""


def read(run):
    return sum(r.edges for r in run.requests) / run.window_s / 1e6
