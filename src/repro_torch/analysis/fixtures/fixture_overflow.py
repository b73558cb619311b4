"""Seeded overflow violation: the unguarded int32 sum-form admission
check ``cluster_w[label] + vweight <= budget`` — the wrap the guard form
``w <= budget - c`` exists to avoid. The overflow pass must flag the
comparison (OFL001).
"""
from __future__ import annotations

from typing import List


def admit(cluster_w, vweights, labels, budget):
    cw = cluster_w[labels]
    proposed = cw + vweights  # int32 sum that can wrap negative
    return proposed <= budget  # unguarded order comparison


def captured(device="cpu") -> List:
    """Tape the defective program on ``device``; returns its run."""
    import sys

    import torch

    from repro_torch.analysis import entrypoints

    n = 8
    cw = torch.ones(n, dtype=torch.int32, device=device)
    vw = torch.ones(n, dtype=torch.int32, device=device)
    lab = torch.zeros(n, dtype=torch.int64, device=device)
    bud = torch.full((n,), 100, dtype=torch.int32, device=device)
    mod = sys.modules[__name__]
    spec = entrypoints.Spec("fixture_overflow", mod, "admit",
                            lambda: mod.admit(cw, vw, lab, bud), False)
    return [entrypoints.run_host(spec)]
