"""Wrapper of the ``seg_merge`` CUDA kernel (``csrc/seg_merge.cu``).

Segmented sort + duplicate-arc merge: the hand-written Hopper port of the
JAX package's Pallas kernel ``repro/kernels/seg_merge/seg_merge.py::
seg_merge``. A CPU tensor runs the plain version (``ref.seg_merge_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .ref import seg_merge_ref

I32_MAX = int(np.iinfo(np.int32).max)

_SIG = {"seg_merge": [_build.P] * 3 + [_build.I] + [_build.P] * 12}


def seg_merge(src, dst, w):
    """Sort + merge (L,) int32 records. Returns ``(s_src, s_dst, tot,
    first)``: sorted keys, per-record run totals, int32 run-start flags.
    Pads to a power of two internally with the ``I32_MAX`` invalid key
    callers already filter, as the JAX kernel does."""
    if src.device.type == "cpu":
        return seg_merge_ref(src, dst, w)
    if src.device.type != "cuda":
        raise ValueError(f"seg_merge: unsupported device {src.device}")
    (L,) = src.shape
    for name, t in (("src", src), ("dst", dst), ("w", w)):
        _build.require(f"seg_merge {name}", t, torch.int32, (L,), src.device)
    Lp = _build.sort_length(L)
    if Lp > _build.MAX_SORT_LENGTH:
        raise ValueError(f"seg_merge: {L} records exceed the launch limit")
    if Lp != L:
        pad = Lp - L
        src = torch.cat([src, src.new_full((pad,), I32_MAX)])
        dst = torch.cat([dst, dst.new_full((pad,), I32_MAX)])
        w = torch.cat([w, w.new_zeros(pad)])
    lib = _build.load("seg_merge", _SIG)
    i32 = dict(dtype=torch.int32, device=src.device)
    out = torch.empty(4, Lp, **i32)
    key = torch.empty(Lp, dtype=torch.int64, device=src.device)
    scratch = torch.empty(4, Lp, **i32)
    flags = torch.empty(3, Lp, dtype=torch.uint8, device=src.device)
    p = _build.ptr
    err = lib.seg_merge(
        p(src), p(dst), p(w), Lp, p(out[0]), p(out[1]), p(out[2]), p(out[3]),
        p(key), p(scratch[0]), p(scratch[1]), p(scratch[2]), p(scratch[3]),
        p(flags[0]), p(flags[2]), _build.stream_of(src))
    _build.check(err, "seg_merge")
    _build.count_launch("seg_merge")
    return out[0, :L], out[1, :L], out[2, :L], out[3, :L]
