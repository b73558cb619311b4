"""Seconds a request spends coarsening: the sum of its trace's
``coarsen`` records' ``time_s``, averaged over the window's requests."""


def read(run):
    return sum(t["time_s"] for r in run.requests for t in r.trace
               if t.get("phase") == "coarsen") / len(run.requests)
