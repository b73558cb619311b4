"""Result objects for the partitioning facade — port of
``repro.api.result``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

from .request import PartitionRequest


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionResult:
    """Outcome of one ``PartitionRequest``.

    ``metrics`` is ``core.metrics.summarize`` output plus the graph
    sizes ``n``/``m``; ``feasible`` mirrors its feasibility flag.
    ``trace`` holds one record per partitioning phase/level (sizes, cuts, wall
    times) in execution order.
    """
    assignment: np.ndarray          # (n,) int64 block ids
    feasible: bool
    metrics: Dict[str, Any]
    backend: str                    # resolved backend name (never "auto")
    time_s: float
    trace: Tuple[Dict[str, Any], ...]
    request: PartitionRequest

    @property
    def cut(self) -> int:
        return int(self.metrics["cut"])

    @property
    def k(self) -> int:
        return int(self.metrics["k"])

    def summary(self) -> Dict[str, Any]:
        """JSON-serializable one-line summary (no assignment array)."""
        out = dict(self.metrics)
        out.update({
            "backend": self.backend,
            "algo": f"dkaminpar-{self.request.preset}"
            if self.backend in ("single", "dist", "dist-grid")
            else self.backend,
            "time_s": round(float(self.time_s), 3),
            "devices": int(self.request.devices),
            "levels": len(self.trace),
        })
        return out
