"""Wrappers of the balance-round CUDA kernels (``csrc/bal_round.cu``).

``bal_scores`` and ``greedy_pick`` are the hand-written Hopper ports of the
JAX package's Pallas kernels ``repro/kernels/bal_round/bal_round.py::
bal_scores`` and ``::greedy_pick``. A CPU tensor runs the plain version
(``ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import NEG_INF, bal_scores_ref, greedy_pick_ref

_SIG = {"bal_scores": [_build.P] * 12 + [_build.I] * 2 + [_build.U]
        + [_build.P] * 3,
        "greedy_pick": [_build.P] * 6 + [_build.I] * 2 + [_build.P] * 3}

__all__ = ["NEG_INF", "bal_scores", "greedy_pick"]


def bal_scores(nlab, nw, nbw, nlm, own, vw, ovr, vld, fb_t, fb_ok,
               salt: int, npar=None, opar=None):
    """Per-vertex relative gains + targets, ``(rel, tgt)`` (R,) f32 /
    int32; the contract of ``ref.bal_scores_ref``."""
    if nlab.device.type == "cpu":
        return bal_scores_ref(nlab, nw, nbw, nlm, own, vw, ovr, vld, fb_t,
                              fb_ok, salt, npar=npar, opar=opar)
    if nlab.device.type != "cuda":
        raise ValueError(f"bal_scores: unsupported device {nlab.device}")
    if (npar is None) != (opar is None):
        raise ValueError("bal_scores: npar and opar go together")
    R, D = nlab.shape
    dev = nlab.device
    slabs = [("nlab", nlab), ("nw", nw), ("nbw", nbw), ("nlm", nlm)]
    cols = [("own", own), ("vw", vw), ("ovr", ovr), ("vld", vld),
            ("fb_t", fb_t), ("fb_ok", fb_ok)]
    if npar is not None:
        slabs.append(("npar", npar))
        cols.append(("opar", opar))
    for name, t in slabs:
        _build.require(f"bal_scores {name}", t, torch.int32, (R, D), dev)
    for name, t in cols:
        _build.require(f"bal_scores {name}", t, torch.int32, (R,), dev)
    if R >= 2**31:
        raise ValueError(f"bal_scores: {R} rows exceed the launch limit")
    lib = _build.load("bal_round", _SIG)
    rel = torch.empty(R, dtype=torch.float32, device=dev)
    tgt = torch.empty(R, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.bal_scores(
        p(nlab), p(nw), p(nbw), p(nlm), p(npar), p(own), p(opar), p(vw),
        p(ovr), p(vld), p(fb_t), p(fb_ok), R, D, int(salt) & 0xFFFFFFFF,
        p(rel), p(tgt), _build.stream_of(nlab))
    _build.check(err, "bal_scores")
    _build.count_launch("bal_scores")
    return rel, tgt


def greedy_pick(vals, tgt_blk, src_blk, cand_w, block_w, l_max):
    """Greedy application of a ranked pool: ``(accept, block_w)``, (M,)
    bool and the updated (K,) int32 table. ``vals`` (M,) f32 descending,
    the rest (M,) / (K,) int32, K >= 1."""
    if vals.device.type == "cpu":
        return greedy_pick_ref(vals, tgt_blk, src_blk, cand_w, block_w,
                               l_max)
    if vals.device.type != "cuda":
        raise ValueError(f"greedy_pick: unsupported device {vals.device}")
    (M,) = vals.shape
    (K,) = block_w.shape
    dev = vals.device
    _build.require("greedy_pick vals", vals, torch.float32, (M,), dev)
    for name, t in (("tgt_blk", tgt_blk), ("src_blk", src_blk),
                    ("cand_w", cand_w)):
        _build.require(f"greedy_pick {name}", t, torch.int32, (M,), dev)
    for name, t in (("block_w", block_w), ("l_max", l_max)):
        _build.require(f"greedy_pick {name}", t, torch.int32, (K,), dev)
    if K < 1:
        raise ValueError("greedy_pick: the block table is empty")
    lib = _build.load("bal_round", _SIG)
    accept = torch.empty(M, dtype=torch.int32, device=dev)
    bw = torch.empty(K, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.greedy_pick(p(vals), p(tgt_blk), p(src_blk), p(cand_w),
                          p(block_w), p(l_max), M, K, p(accept), p(bw),
                          _build.stream_of(vals))
    _build.check(err, "greedy_pick")
    _build.count_launch("greedy_pick")
    return accept != 0, bw
