"""Host wrapper: fused duplicate-arc merge backing ``dedup_arcs``.

``core.contraction.dedup_arcs`` is int64 numpy (lexsort + ``np.add.at``).
The fused path runs the ``seg_merge`` kernel on the device instead; it
raises when the record ids or the weight total do not fit int32, or the
padded length exceeds the sort's limit. Results are identical: same
(src, dst)-sorted unique arcs, same summed weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .seg_merge import I32_MAX, seg_merge


def dedup_fits(csrc: np.ndarray, cdst: np.ndarray, w: np.ndarray) -> bool:
    """int32-exactness + launch-fit guard for the fused dedup path."""
    if csrc.size == 0:
        return False
    if int(csrc.max(initial=0)) >= I32_MAX or \
            int(cdst.max(initial=0)) >= I32_MAX:
        return False
    if int(np.abs(w).astype(np.int64).sum()) >= 2**31:
        return False
    return _build.sort_length(csrc.size) <= _build.MAX_SORT_LENGTH


def dedup_arcs_fused(csrc: np.ndarray, cdst: np.ndarray, w: np.ndarray,
                     device: torch.device):
    """Fused twin of ``core.contraction.dedup_arcs`` (same contract: drop
    self loops, merge parallel arcs, return int64 sorted by (src, dst)).
    Raises ``ValueError`` outside ``dedup_fits``."""
    keep = csrc != cdst
    csrc, cdst, w = csrc[keep], cdst[keep], w[keep]
    if csrc.size == 0:
        return (csrc.astype(np.int64), cdst.astype(np.int64),
                w.astype(np.int64))
    if not dedup_fits(csrc, cdst, w):
        raise ValueError(
            f"dedup_arcs_fused: {csrc.size} records with ids up to "
            f"{int(max(csrc.max(), cdst.max()))} and total weight "
            f"{int(np.abs(w).astype(np.int64).sum())} exceed the seg_merge "
            "kernel's int32 envelope; use kernel='composed'")
    s_src, s_dst, tot, first = seg_merge(
        *(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
          for x in (csrc, cdst, w)))
    take = (s_src < I32_MAX) & (first != 0)
    return tuple(x[take].cpu().numpy().astype(np.int64)
                 for x in (s_src, s_dst, tot))
