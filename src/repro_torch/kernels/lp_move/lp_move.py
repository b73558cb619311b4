"""Wrapper of the ``lp_move`` CUDA kernel (``csrc/lp_move.cu``).

One LP-clustering chunk step over an ELL slab: the hand-written Hopper
port of the JAX package's Pallas kernel
``repro/kernels/lp_move/lp_move.py::lp_move_chunk``. A CPU tensor runs
the plain version (``ref.lp_move_chunk_ref``); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import lp_move_chunk_ref

_SIG = {"lp_move_chunk": [_build.P] * 6 + [_build.I] * 4 + [_build.U]
        + [_build.I] * 2 + [_build.P] * 15}


def lp_move_chunk(nlab, nw, ncw, own, vw, W: int, v0: int, salt: int,
                  num_labels: int, nbud=None):
    """``(moved, tgt)`` (R,) int32 for one ELL chunk; the contract of
    ``ref.lp_move_chunk_ref``. ``num_labels`` sizes the kernel's
    label-indexed weight tables: every label must lie below it."""
    if nlab.device.type == "cpu":
        return lp_move_chunk_ref(nlab, nw, ncw, own, vw, W, v0, salt,
                                 num_labels, nbud=nbud)
    if nlab.device.type != "cuda":
        raise ValueError(f"lp_move_chunk: unsupported device {nlab.device}")
    R, D = nlab.shape
    dev = nlab.device
    for name, t in (("nlab", nlab), ("nw", nw), ("ncw", ncw)) + (
            (("nbud", nbud),) if nbud is not None else ()):
        _build.require(f"lp_move_chunk {name}", t, torch.int32, (R, D), dev)
    for name, t in (("own", own), ("vw", vw)):
        _build.require(f"lp_move_chunk {name}", t, torch.int32, (R,), dev)
    Rp = _build.sort_length(R)
    if Rp > _build.MAX_SORT_LENGTH:   # row ids and the sort index are 32-bit
        raise ValueError(f"lp_move_chunk: R={R} rows exceed the launch "
                         "limit")
    lib = _build.load("lp_move", _SIG)
    i32 = dict(dtype=torch.int32, device=dev)
    moved = torch.empty(R, **i32)
    tgt = torch.empty(R, **i32)
    pmove = torch.empty(R, **i32)
    light = torch.empty(R, **i32)
    newcw = torch.empty(R, **i32)
    tables = torch.zeros(3, num_labels, **i32)
    key = torch.empty(Rp, dtype=torch.int64, device=dev)
    val = torch.empty(Rp, **i32)
    sums = torch.empty(2, Rp, **i32)
    flags = torch.empty(2, Rp, dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = lib.lp_move_chunk(
        p(nlab), p(nw), p(ncw), p(nbud), p(own), p(vw), R, D, int(W),
        int(v0), int(salt) & 0xFFFFFFFF, int(num_labels), Rp, p(moved),
        p(tgt), p(pmove), p(light), p(newcw), p(tables[0]), p(tables[1]),
        p(tables[2]), p(key), p(val), p(sums[0]), p(sums[1]), p(flags[0]),
        p(flags[1]), _build.stream_of(nlab))
    _build.check(err, "lp_move")
    _build.count_launch("lp_move")
    return moved, tgt
