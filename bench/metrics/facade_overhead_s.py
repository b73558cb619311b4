"""Seconds a request spends outside the partitioner's traced phases: its wall
(host clock) less the sum of its trace records' ``time_s``, averaged over
the window's requests. It holds the facade (``api/partitioner.py``,
``api/backends.py``), the result's metrics and the coarsest level that
``deep_mgp.partition`` discards."""


def read(run):
    gaps = [r.wall_s - sum(t.get("time_s", 0.0) for t in r.trace)
            for r in run.requests]
    return sum(gaps) / len(gaps)
