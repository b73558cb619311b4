"""Seeded SPMD violation: rank 0 issues a ``psum`` in one branch and the
other ranks do not. Run as it stands, rank 0 would wait in the sum for
peers that never join it; the lockstep check of the collectives pass
must end the entry with an ``SPMD002`` finding at each rank's site
instead of hanging.
"""
from __future__ import annotations

from typing import List


def mismatched(pe):
    """The defective per-rank body."""
    import torch

    from repro_torch.dist import collectives

    x = torch.zeros(4, dtype=torch.int32, device=pe.device)
    if pe.rank == 0:
        x = collectives.psum(x, pe)
    return x * 2


def trace_on_rank(pe) -> List:
    """``PeMesh.call`` target: run the body under the rank's tape and
    collective log; every rank's runs, on every rank."""
    import sys

    from repro_torch.analysis import collectives_pass
    from repro_torch.analysis.entrypoints import Spec

    mod = sys.modules[__name__]
    spec = Spec("fixture_collective_mismatch", mod, "mismatched",
                lambda: mod.mismatched(pe), True)
    return collectives_pass.run_on_rank(pe, [spec])
