"""Wrapper of the ``lp_move`` CUDA kernel (``csrc/lp_move.cu``).

One LP-clustering chunk step over an ELL slab: the hand-written Hopper
port of the JAX package's Pallas kernel
``repro/kernels/lp_move/lp_move.py::lp_move_chunk``. A CPU tensor runs
the plain version (``ref.lp_move_chunk_ref``); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import lp_move_chunk_ref

_SIG = {"lp_move_chunk": [_build.P] * 6 + [_build.I] * 4 + [_build.U]
        + [_build.I] + [_build.P] * 4,
        "lp_move_scratch_bytes": [_build.I, _build.I, _build.P]}


@functools.lru_cache(maxsize=64)
def _scratch_bytes(R: int, num_labels: int) -> int:
    """Bytes of scratch the kernel needs for this chunk shape."""
    lib = _build.load("lp_move", _SIG)
    n = ctypes.c_int64()
    _build.check(lib.lp_move_scratch_bytes(R, num_labels,
                                           ctypes.addressof(n)), "lp_move")
    return n.value


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
    if not (0 < R < 2**31 and 0 < D < 2**31 and 0 < num_labels < 2**31):
        raise ValueError(f"lp_move_chunk: R={R}, D={D}, num_labels="
                         f"{num_labels} outside the launch limits [1, 2^31)"
                         " (int32 row ids and labels)")
    lib = _build.load("lp_move", _SIG)
    moved, tgt = torch.empty((2, R), dtype=torch.int32, device=dev)
    # the kernel's scratch, one allocation apart from the outputs so that
    # they do not keep it alive (the kernel clears what it needs cleared)
    scratch = torch.empty(_scratch_bytes(R, int(num_labels)),
                          dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = lib.lp_move_chunk(
        p(nlab), p(nw), p(ncw), p(nbud), p(own), p(vw), R, D, int(W),
        int(v0), int(salt) & 0xFFFFFFFF, int(num_labels), p(moved), p(tgt),
        p(scratch), _build.stream_of(nlab))
    _build.check(err, "lp_move")
    _build.count_launch("lp_move")
    return moved, tgt
