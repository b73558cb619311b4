"""Host wrapper: fused duplicate-arc merge backing ``dedup_arcs``.

``core.contraction.dedup_arcs`` is int64 numpy (lexsort + ``np.add.at``).
The fused path runs the ``seg_merge`` kernel on the device instead; it
raises when the record ids or the weight total do not fit int32, or the
records exceed the kernel's int32 offsets. Results are identical: same
(src, dst)-sorted unique arcs, same summed weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .seg_merge import I32_MAX, MAX_RECORDS, seg_merge


def _id_range(csrc: np.ndarray, cdst: np.ndarray):
    return (min(int(csrc.min()), int(cdst.min())),
            max(int(csrc.max()), int(cdst.max())))


def _weight_total(w: np.ndarray) -> int:
    return int(np.abs(w).astype(np.int64).sum())


def _fits(n: int, max_id: int, w_total: int) -> bool:
    """The fused dedup's fit predicate, on shapes alone: n records with
    ids up to ``max_id`` and absolute weight total ``w_total``."""
    return max_id < I32_MAX and n <= MAX_RECORDS and w_total < 2**31


def dedup_fits(csrc: np.ndarray, cdst: np.ndarray, w: np.ndarray) -> bool:
    """int32-exactness + launch-fit guard for the fused dedup path."""
    return csrc.size > 0 and _fits(csrc.size, _id_range(csrc, cdst)[1],
                                   _weight_total(w))


def dedup_arcs_fused(csrc: np.ndarray, cdst: np.ndarray, w: np.ndarray,
                     device: torch.device):
    """Fused twin of ``core.contraction.dedup_arcs`` (same contract: drop
    self loops, merge parallel arcs, return int64 sorted by (src, dst)).
    Raises ``ValueError`` outside ``dedup_fits``. The ids' range, taken
    here on the host, bounds the kernel's sort key."""
    keep = csrc != cdst
    csrc, cdst, w = csrc[keep], cdst[keep], w[keep]
    if csrc.size == 0:
        return (csrc.astype(np.int64), cdst.astype(np.int64),
                w.astype(np.int64))
    lo, hi = _id_range(csrc, cdst)
    total = _weight_total(w)
    if not _fits(csrc.size, hi, total):
        raise ValueError(
            f"dedup_arcs_fused: {csrc.size} records with ids up to {hi} "
            f"and total weight {total} exceed the seg_merge "
            "kernel's int32 envelope; use kernel='composed'")
    s_src, s_dst, tot, first = seg_merge(
        *(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
          for x in (csrc, cdst, w)), max_id=hi if lo >= 0 else None)
    take = (s_src < I32_MAX) & (first != 0)
    return tuple(x[take].cpu().numpy().astype(np.int64)
                 for x in (s_src, s_dst, tot))
