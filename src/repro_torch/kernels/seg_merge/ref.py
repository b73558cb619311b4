"""Plain-PyTorch version of the ``seg_merge`` CUDA kernel.

It follows the kernel's formulation: each record's (src, dst) becomes a
key of two halves as wide as the ids need (``key_bits``), ``I32_MAX``
mapping to a half's all-ones value above every valid id; a stable LSD
sort by 8-bit digits orders the records (one stable ``torch.sort`` of
each digit, least significant first); run ids come from ``cumsum32`` of
the run-start flags and run totals from ``segment_sum``. The result is
the JAX package's ``seg_merge_ref``, a stable lexicographic sort, bit for
bit. The wrapper runs it for CPU tensors; the chip check holds the kernel
to it.
"""
from __future__ import annotations

import torch

from ...core.lp import I32_MAX, cumsum32, segment_sum

DIGIT_BITS = 8


def key_bits(max_id=None) -> int:
    """Bits of each key half: ids in [0, max_id] plus one value above
    them for ``I32_MAX``, so ``bit_length(max_id + 1)`` (a max id of
    2^b - 1 needs b + 1 bits); 32 (any int32 id) without a bound."""
    if max_id is None:
        return 32
    max_id = int(max_id)
    if not 0 <= max_id < I32_MAX:
        raise ValueError(f"seg_merge: max_id {max_id} outside [0, I32_MAX)")
    return max(1, (max_id + 1).bit_length())


def key_passes(bits: int) -> int:
    """Digit passes of the LSD sort over a key of two ``bits`` halves."""
    return -(-2 * bits // DIGIT_BITS)


def key_halves(src, dst, bits: int):
    """The key's (high, low) halves as int64: ``I32_MAX`` becomes
    2^bits - 1; at 32 bits every int32 maps order-preservingly (x + 2^31,
    the kernel's ``x ^ 0x80000000``)."""
    def half(x):
        x = x.long()
        if bits == 32:
            return x + 2**31
        return torch.where(x == I32_MAX, (1 << bits) - 1, x)
    return half(src), half(dst)


def key_digit(hi, lo, bits: int, p: int):
    """Digit ``p`` (bits [8p, 8p + 8)) of the key ``hi * 2^bits + lo``."""
    s = DIGIT_BITS * p
    if s >= bits:
        return (hi >> (s - bits)) & 255
    d = lo >> s
    if bits - s < DIGIT_BITS:
        d = d | (hi << (bits - s))
    return d & 255


def seg_merge_ref(src, dst, w, max_id=None):
    """``(s_src, s_dst, tot, first)`` for (L,) int32 records; ``max_id``
    as for the kernel's wrapper."""
    L = src.shape[0]
    bits = key_bits(max_id)
    hi, lo = key_halves(src, dst, bits)
    order = torch.arange(L, device=src.device)
    for p in range(key_passes(bits)):
        d = key_digit(hi[order], lo[order], bits, p)
        order = order[torch.sort(d, stable=True).indices]
    s_src, s_dst, s_w = src[order], dst[order], w[order]
    first = torch.ones(L, dtype=torch.bool, device=src.device)
    first[1:] = (s_src[1:] != s_src[:-1]) | (s_dst[1:] != s_dst[:-1])
    gid = (cumsum32(first.to(torch.int32)) - 1).long()
    tot = segment_sum(s_w, gid, L)
    return s_src, s_dst, tot[gid], first.to(torch.int32)
