"""Seconds a request spends from the coarsest level back: the sum of its
trace's ``initial``, ``uncoarsen`` and ``final`` records' ``time_s``,
averaged over the window's requests."""

PHASES = ("initial", "uncoarsen", "final")


def read(run):
    return sum(t["time_s"] for r in run.requests for t in r.trace
               if t.get("phase") in PHASES) / len(run.requests)
