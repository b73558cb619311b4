"""Verifier for the partitioner port: collective consistency, int32
overflow dataflow and launch limits over taped runs of the real entry
points, plus a repo AST lint.

``python -m repro_torch.analysis`` runs the real ``repro_torch.dist`` /
``repro_torch.core`` entry points on a tiny graph under a tape of their
aten ops (``tracing``): the host entries in the calling process, the
``dist_*`` entries on every rank of a mesh. Four passes read the runs:
``collectives_pass`` (SPMD001/002, checked in lockstep across the
ranks), ``overflow_pass`` (OFL001), ``limits`` (LIM001–003, the CUDA
kernels' launch limits) and ``lint`` (LNT001–003). The reviewed
suppressions are in ``allowlist.toml``; ``fixtures/`` holds one seeded
violation per pass.
"""

from .findings import Allowlist, Finding, Report

__all__ = ["Allowlist", "Finding", "Report"]
