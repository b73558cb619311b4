"""Seeded launch-limit violations: a static scratch inventory that
forgot a fifth of the working set (LIM001, against the built libraries
on the card) and an off-by-one fit predicate for ``seg_merge``, which
refuses the largest record count the launch takes (LIM002, anywhere).
"""
from __future__ import annotations


def static_bytes(kernel: str, point: dict) -> int:
    """A 20%-under inventory — beyond the 5% agreement budget."""
    from repro_torch.analysis import limits

    return int(limits.static_bytes(kernel, point) * 0.8)


def cases():
    """The real boundary cases with ``seg_merge``'s predicate off by one
    (``<`` where the kernel takes ``<=``)."""
    from repro_torch.analysis import limits
    from repro_torch.kernels.seg_merge.seg_merge import MAX_RECORDS

    out = limits.boundary_cases()
    kernel, _, _, check, points = out[0]
    out[0] = (kernel, "an off-by-one fit predicate",
              lambda L: L < MAX_RECORDS, check, points)
    return out
