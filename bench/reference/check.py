"""What decides ``correct``: every answer against the guarantees, and a
sampled request against its plain replay.

An answer is checked from the benchmark's own graph: every block id in
[0, k), every block within L_max = max(floor((1 + eps) c(V) / k),
ceil(c(V) / k) + max c(v)), and the cut the program reports equal to the
cut recomputed here. A sampled request is replayed by the plain version
that its traffic names, from the benchmark's graph and the request's
parameters alone;
its answer must be the replay's, and each stage's result the replay's
stage of the same place. Every number is a count of disagreements, whose
limit is 0.
"""
from __future__ import annotations

import importlib

import numpy as np

from . import plain


def l_max(total: int, k: int, eps: float, max_vweight: int) -> int:
    return max(int(np.floor((1.0 + eps) * total / k)),
               -(-total // k) + max_vweight)


def edge_cut(indptr, adjncy, eweights, part) -> int:
    """Summed weight of the edges whose ends lie in different blocks."""
    src = plain.arc_tails(indptr)
    cross = part[src] != part[adjncy]
    return int(eweights[cross].sum()) // 2


def answer(graph, part, k: int, eps: float, reported_cut: int) -> dict:
    """``{"ids", "overload", "cut_gap"}`` of one answer: entries outside
    [0, k) (or a wrong length), blocks above L_max, |reported - cut|."""
    indptr, adjncy, eweights, vweights = graph
    n = indptr.shape[0] - 1
    part = np.asarray(part)
    if part.shape != (n,) or not np.issubdtype(part.dtype, np.integer):
        return {"ids": n, "overload": 0, "cut_gap": 0}
    bad = int(np.count_nonzero((part < 0) | (part >= k)))
    if bad:
        return {"ids": bad, "overload": 0, "cut_gap": 0}
    bw = np.bincount(part, weights=vweights, minlength=k)
    lm = l_max(int(vweights.sum()), k, eps, int(vweights.max()))
    return {"ids": 0, "overload": int(np.count_nonzero(bw > lm)),
            "cut_gap": abs(int(reported_cut)
                           - edge_cut(indptr, adjncy, eweights, part))}


def diff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def replay(name: str, graph, params: dict, dev):
    """``(answer, stages)`` of the plain replay of one request by
    ``bench/reference/<name>.py``."""
    engine = importlib.import_module(f"{__package__}.{name}")
    stages = []
    return engine.partition(graph, params, dev, stages), stages


def stages(kinds, program: list, reference: list) -> dict:
    """Position by position, the program's stage results against the
    replay's: ``<kind>_diff`` counts the entries that differ in a stage of
    that kind, ``stage_order`` the positions at which the two made
    different calls, or at which one made a call the other did not."""
    out = {f"{k}_diff": 0 for k in kinds}
    out["stage_order"] = abs(len(program) - len(reference))
    for (kp, mine), (kr, theirs) in zip(program, reference):
        if kp != kr:
            out["stage_order"] += 1
            continue
        out[f"{kp}_diff"] += sum(diff(a, b) for a, b in zip(mine, theirs))
    return out
