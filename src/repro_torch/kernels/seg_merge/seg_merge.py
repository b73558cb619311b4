"""Wrapper of the ``seg_merge`` CUDA kernel (``csrc/seg_merge.cu``).

Segmented sort + duplicate-arc merge: the hand-written Hopper port of the
JAX package's Pallas kernel ``repro/kernels/seg_merge/seg_merge.py::
seg_merge``. A CPU tensor runs the plain version (``ref.seg_merge_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .ref import key_bits, seg_merge_ref

I32_MAX = int(np.iinfo(np.int32).max)
# int32 record offsets
MAX_RECORDS = 2**31 - 1

_SIG = {"seg_merge": [_build.P] * 3 + [_build.I] * 2 + [_build.P] * 6,
        "seg_merge_scratch_bytes": [_build.I, _build.P]}


@functools.lru_cache(maxsize=64)
def _scratch_bytes(L: int) -> int:
    """Bytes of scratch the kernel needs for L records."""
    lib = _build.load("seg_merge", _SIG)
    n = ctypes.c_int64()
    _build.check(lib.seg_merge_scratch_bytes(L, ctypes.addressof(n)),
                 "seg_merge")
    return n.value


def seg_merge(src, dst, w, max_id=None):
    """Sort + merge (L,) int32 records. Returns ``(s_src, s_dst, tot,
    first)``: sorted keys, per-record run totals, int32 run-start flags.

    ``max_id`` bounds the ids: every ``src`` / ``dst`` is ``I32_MAX`` (an
    invalid record) or lies in [0, max_id], and the sort key narrows to
    what they need. ``None`` takes any int32 id, negatives included. The
    bound is the caller's promise; nothing reads the ids back to check
    it."""
    if src.device.type == "cpu":
        return seg_merge_ref(src, dst, w, max_id)
    if src.device.type != "cuda":
        raise ValueError(f"seg_merge: unsupported device {src.device}")
    (L,) = src.shape
    for name, t in (("src", src), ("dst", dst), ("w", w)):
        _build.require(f"seg_merge {name}", t, torch.int32, (L,), src.device)
    if L > MAX_RECORDS:
        raise ValueError(f"seg_merge: {L} records exceed the launch limit "
                         f"{MAX_RECORDS} (int32 offsets)")
    bits = key_bits(max_id)
    out = torch.empty((4, L), dtype=torch.int32, device=src.device)
    if L == 0:
        return out[0], out[1], out[2], out[3]
    lib = _build.load("seg_merge", _SIG)
    # the kernel's scratch, one allocation apart from the outputs so that
    # they do not keep it alive (the kernel clears what it needs cleared)
    scratch = torch.empty(_scratch_bytes(L), dtype=torch.uint8,
                          device=src.device)
    p = _build.ptr
    err = lib.seg_merge(p(src), p(dst), p(w), L, bits, p(out[0]), p(out[1]),
                        p(out[2]), p(out[3]), p(scratch),
                        _build.stream_of(src))
    _build.check(err, "seg_merge")
    _build.count_launch("seg_merge")
    return out[0], out[1], out[2], out[3]
