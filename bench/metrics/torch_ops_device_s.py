"""Device seconds a request spends in kernels other than the hand-written
ones of ``csrc/`` (the torch ops of clustering, refinement and balancing,
and the gathers around the kernels), from the profiler's trace, averaged
over the window's requests."""


def read(run):
    if run.events is None:
        return None
    t = sum(e.dur for e in run.events
            if e.kind == "kernel" and e.family is None)
    return t / len(run.requests)
