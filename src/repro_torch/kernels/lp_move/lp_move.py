"""Wrapper of the ``lp_move`` CUDA kernel (``csrc/lp_move.cu``).

One LP-clustering chunk step over an ELL slab: the hand-written Hopper
port of the JAX package's Pallas kernel
``kernels/lp_move/lp_move.py::lp_move_chunk``. ``lp_move_chunk_stacked``
runs the same step for S requests in one call (the serving tier's
stacked level-0 clustering). A CPU tensor runs the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises.

A chunk with heavy rows (arcs beyond the slab, ``overflow``) also runs
the kernel's heavy-row path (a warp a row, hub rows split over CTAs by
their plan, ``heavy.py``), counted apart as ``lp_move_heavy``. A call
in the distributed admission form (``nbud``, the ``dist/`` engine's)
counts as ``lp_move_dist`` (and ``lp_move_heavy_dist``) instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import lp_move_chunk_ref, lp_move_chunk_stacked_ref

_SIG = {"lp_move_chunk": [_build.P] * 6 + [_build.I] * 4 + [_build.U]
        + [_build.I] * 2 + [_build.P] * 3 + [_build.I, _build.P, _build.I]
        + [_build.P] * 4 + [_build.I] + [_build.P] * 4,
        "lp_move_chunk_stacked": [_build.P] * 6 + [_build.I] * 4
        + [_build.P] * 7,
        "lp_move_scratch_bytes": [_build.I] * 6 + [_build.P]}

# the kernel's grid takes the request from blockIdx.y
MAX_STACK = 65535


@functools.lru_cache(maxsize=64)
def _scratch_bytes(S: int, R: int, num_labels: int, H: int = 0, G: int = 0,
                   hubs: int = 0) -> int:
    """Bytes of scratch the kernel needs for S requests (1: a solo call)
    of R rows, H of them heavy, ``hubs`` of those hub rows over G hub
    ranges."""
    lib = _build.load("lp_move", _SIG)
    n = ctypes.c_int64()
    _build.check(lib.lp_move_scratch_bytes(S, R, num_labels, H, G, hubs,
                                           ctypes.addressof(n)), "lp_move")
    return n.value


def check_launch(R: int, D: int, num_labels: int) -> None:
    """Raise unless a solo call of R rows of D lanes over ``num_labels``
    labels fits the launch: int32 row ids and labels."""
    if not (0 < R < 2**31 and 0 < D < 2**31 and 0 < num_labels < 2**31):
        raise ValueError(f"lp_move_chunk: R={R}, D={D}, num_labels="
                         f"{num_labels} outside the launch limits [1, 2^31)"
                         " (int32 row ids and labels)")


def lp_move_chunk(nlab, nw, ncw, own, vw, W: int, v0: int, salt: int,
                  num_labels: int, nbud=None, overflow=None):
    """``(moved, tgt)`` (R,) int32 for one ELL chunk; the contract of
    ``ref.lp_move_chunk_ref``. ``num_labels`` sizes the kernel's
    label-indexed weight tables: every label must lie below it.
    ``overflow``: ``(rows, ptr, nlab, nw, ncw, hubs, ranges)`` int32 of
    the chunk's heavy rows and their plan (``ops.overflow_operands``),
    with their budgets ``nbud`` after ``ncw`` in the distributed admission
    form."""
    if nlab.device.type == "cpu":
        return lp_move_chunk_ref(nlab, nw, ncw, own, vw, W, v0, salt,
                                 num_labels, nbud=nbud, overflow=overflow)
    if nlab.device.type != "cuda":
        raise ValueError(f"lp_move_chunk: unsupported device {nlab.device}")
    R, D = nlab.shape
    dev = nlab.device
    for name, t in (("nlab", nlab), ("nw", nw), ("ncw", ncw)) + (
            (("nbud", nbud),) if nbud is not None else ()):
        _build.require(f"lp_move_chunk {name}", t, torch.int32, (R, D), dev)
    for name, t in (("own", own), ("vw", vw)):
        _build.require(f"lp_move_chunk {name}", t, torch.int32, (R,), dev)
    check_launch(R, D, int(num_labels))
    H, M, G, n_hub, hv = 0, 0, 0, 0, (None,) * 8
    if overflow is not None and overflow[0].shape[0]:
        want = 7 if nbud is None else 8     # + the budgets
        if len(overflow) != want:
            raise ValueError(f"lp_move_chunk: an overflow of "
                             f"{len(overflow)} entries; this admission "
                             f"form takes {want} (ops.overflow_operands: "
                             "the arcs' operands and the heavy-row plan)")
        arcs = tuple(overflow[2:-2]) + (None,) * (8 - want)
        hv = tuple(overflow[:2]) + tuple(overflow[-2:]) + arcs
        H, M = hv[0].shape[0], hv[4].shape[0]
        n_hub, G = hv[2].shape[0] - 1, hv[3].shape[0]
        for name, t, shape in (("rows", hv[0], (H,)), ("ptr", hv[1], (H + 1,)),
                               ("hubs", hv[2], (n_hub + 1, 2)),
                               ("ranges", hv[3], (G,))):
            _build.require(f"lp_move_chunk overflow {name}", t, torch.int32,
                           shape, dev)
        for name, t in zip(("nlab", "nw", "ncw", "nbud"), hv[4:]):
            if t is None:
                continue
            _build.require(f"lp_move_chunk overflow {name}", t, torch.int32,
                           (M,), dev)
        _build.check_heavy("lp_move_chunk", H, D, M)
    lib = _build.load("lp_move", _SIG)
    moved, tgt = torch.empty((2, R), dtype=torch.int32, device=dev)
    # the kernel's scratch, one allocation apart from the outputs so that
    # they do not keep it alive (the kernel clears what it needs cleared)
    scratch = torch.empty(_scratch_bytes(1, R, int(num_labels), H, G, n_hub),
                          dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = lib.lp_move_chunk(
        p(nlab), p(nw), p(ncw), p(nbud), p(own), p(vw), R, D, int(W),
        int(v0), int(salt) & 0xFFFFFFFF, int(num_labels), H, p(hv[0]),
        p(hv[1]), p(hv[2]), n_hub, p(hv[3]), G, *(p(t) for t in hv[4:]), M,
        p(moved), p(tgt), p(scratch), _build.stream_of(nlab))
    _build.check(err, "lp_move")
    form = "" if nbud is None else "_dist"
    _build.count_launch("lp_move" + form)
    if H:
        _build.count_launch("lp_move_heavy" + form)
    return moved, tgt


def check_stack_limits(S: int, R: int, num_labels: int, D: int = 1) -> None:
    """Raise unless S requests of R rows of D lanes over ``num_labels``
    labels fit the stacked launch: int32 offsets of the (S, R) rows and
    (S, num_labels) tables, and S within the grid's y dimension."""
    if not (0 < S <= MAX_STACK and 0 < R and 0 < num_labels
            and 0 < D < 2**31 and S * R < 2**31
            and S * num_labels < 2**31):
        raise ValueError(
            f"lp_move_chunk_stacked: S={S}, R={R}, D={D}, num_labels="
            f"{num_labels} outside the launch limits (1 <= S <= "
            f"{MAX_STACK}, D, S*R and S*num_labels < 2^31)")


def lp_move_chunk_stacked(nlab, nw, ncw, own, vw, W, v0, salt,
                          num_labels: int, nbud=None):
    """``(moved, tgt)`` (S, R) int32: request ``s`` gets exactly what
    ``lp_move_chunk`` gives its chunk ``(nlab[s], ...)`` with ``(W[s],
    v0[s], salt[s])``. The slabs are (S, R, D), ``own``/``vw`` (S, R);
    ``W``, ``v0`` and ``salt`` are (S,) int32 tensors on the slabs' device
    (``salt`` holds the uint32 bit patterns), read by the kernel, so a
    call neither copies nor waits. Every label lies below
    ``num_labels``."""
    if nlab.device.type == "cpu":
        return lp_move_chunk_stacked_ref(nlab, nw, ncw, own, vw, W, v0, salt,
                                         num_labels, nbud=nbud)
    if nlab.device.type != "cuda":
        raise ValueError(
            f"lp_move_chunk_stacked: unsupported device {nlab.device}")
    S, R, D = nlab.shape
    dev = nlab.device
    for name, t in (("nlab", nlab), ("nw", nw), ("ncw", ncw)) + (
            (("nbud", nbud),) if nbud is not None else ()):
        _build.require(f"lp_move_chunk_stacked {name}", t, torch.int32,
                       (S, R, D), dev)
    for name, t in (("own", own), ("vw", vw)):
        _build.require(f"lp_move_chunk_stacked {name}", t, torch.int32,
                       (S, R), dev)
    for name, t in (("W", W), ("v0", v0), ("salt", salt)):
        _build.require(f"lp_move_chunk_stacked {name}", t, torch.int32,
                       (S,), dev)
    check_stack_limits(S, R, int(num_labels), D)
    lib = _build.load("lp_move", _SIG)
    moved, tgt = torch.empty((2, S, R), dtype=torch.int32, device=dev)
    scratch = torch.empty(_scratch_bytes(S, R, int(num_labels)),
                          dtype=torch.uint8, device=dev)
    p = _build.ptr
    err = lib.lp_move_chunk_stacked(
        p(nlab), p(nw), p(ncw), p(nbud), p(own), p(vw), S, R, D,
        int(num_labels), p(W), p(v0), p(salt), p(moved), p(tgt), p(scratch),
        _build.stream_of(nlab))
    _build.check(err, "lp_move")
    _build.count_launch("lp_move_stacked")
    return moved, tgt
