"""Wrappers of the balance-round CUDA kernels (``csrc/bal_round.cu``).

``bal_scores`` and ``greedy_pick`` are the hand-written Hopper ports of the
JAX package's Pallas kernels ``repro/kernels/bal_round/bal_round.py::
bal_scores`` and ``::greedy_pick``; ``bal_scores`` also does the gathers
that fed the TPU kernel its pre-gathered slabs, reading the ELL ids and the
block tables itself. A CPU tensor runs the plain version (``ref``); a CUDA
tensor launches the kernel or raises. Heavy rows (arcs beyond a capped
slab, ``overflow``) are then rescored by the kernel's heavy-row path,
counted apart as ``bal_scores_heavy``. The distributed balancer's calls
(``dist=True``: one PE's label table) count as ``bal_scores_dist`` and
``bal_scores_heavy_dist``.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import NEG_INF, bal_scores_ell_ref, greedy_pick_ref

_SIG = {"bal_scores": [_build.P] * 8 + [_build.I] * 4 + [_build.U]
        + [_build.P] * 3,
        "bal_scores_heavy": [_build.P] * 8 + [_build.I] * 4 + [_build.U]
        + [_build.I] + [_build.P] * 4 + [_build.I] + [_build.P] * 4,
        "greedy_pick": [_build.P] * 6 + [_build.I] * 2 + [_build.P] * 3,
        "smem_chase_cycles": [_build.I, _build.P, _build.P]}

__all__ = ["NEG_INF", "bal_scores", "greedy_pick"]


def check_launch(R: int, D: int, K: int) -> None:
    """Raise unless R rows of D lanes over K blocks fit the launch."""
    if R == 0 or D == 0 or K == 0:
        raise ValueError(f"bal_scores: empty operands (R={R}, D={D}, K={K})")
    if R >= 2**31:
        raise ValueError(f"bal_scores: {R} rows exceed the launch limit")


def bal_scores(ell_idx, ell_w, labels, vw, block_w, l_max, fb_of_block,
               n: int, salt: int, parent=None, overflow=None,
               dist: bool = False):
    """Per-vertex relative gains + targets, ``(rel, tgt)`` (R,) f32 /
    int32; the contract of ``ref.bal_scores_ell_ref``. ``ell_idx`` /
    ``ell_w`` (R, D) int32 (-1 / 0 padding), ``labels`` / ``vw`` (R,),
    the block tables (K,) int32; ``parent`` selects the restricted form;
    ``overflow`` ``(rows, ptr, idx, w)`` int32 the heavy rows' arcs beyond
    the slab. ``dist`` names the distributed balancer's call (its launch
    counter) and changes nothing else."""
    if ell_idx.device.type == "cpu":
        return bal_scores_ell_ref(ell_idx, ell_w, labels, vw, block_w, l_max,
                                  fb_of_block, n, salt, parent=parent,
                                  overflow=overflow)
    if ell_idx.device.type != "cuda":
        raise ValueError(f"bal_scores: unsupported device {ell_idx.device}")
    R, D = ell_idx.shape
    (K,) = block_w.shape
    dev = ell_idx.device
    req = _build.require
    req("bal_scores ell_idx", ell_idx, torch.int32, (R, D), dev)
    req("bal_scores ell_w", ell_w, torch.int32, (R, D), dev)
    req("bal_scores labels", labels, torch.int32, (R,), dev)
    req("bal_scores vw", vw, torch.int32, (R,), dev)
    tables = [("block_w", block_w), ("l_max", l_max),
              ("fb_of_block", fb_of_block)]
    if parent is not None:
        tables.append(("parent", parent))
    for name, t in tables:
        req(f"bal_scores {name}", t, torch.int32, (K,), dev)
    check_launch(R, D, K)
    H = 0
    if overflow is not None and overflow[0].shape[0]:
        H, M = overflow[0].shape[0], overflow[2].shape[0]
        req("bal_scores overflow rows", overflow[0], torch.int32, (H,), dev)
        req("bal_scores overflow ptr", overflow[1], torch.int32, (H + 1,),
            dev)
        req("bal_scores overflow idx", overflow[2], torch.int32, (M,), dev)
        req("bal_scores overflow w", overflow[3], torch.int32, (M,), dev)
        _build.check_heavy("bal_scores", H, D, M)
    lib = _build.load("bal_round", _SIG)
    rel = torch.empty(R, dtype=torch.float32, device=dev)
    tgt = torch.empty(R, dtype=torch.int32, device=dev)
    p = _build.ptr
    args = (p(ell_idx), p(ell_w), p(labels), p(vw), p(block_w), p(l_max),
            p(parent), p(fb_of_block), R, D, max(0, min(int(n), R)), K,
            int(salt) & 0xFFFFFFFF)
    err = lib.bal_scores(*args, p(rel), p(tgt), _build.stream_of(ell_idx))
    _build.check(err, "bal_scores")
    form = "_dist" if dist else ""
    _build.count_launch("bal_scores" + form)
    if H:
        # the heavy rows' label tables (2 slots a lane, key and sum),
        # cleared by their CTAs
        tab = torch.empty(4 * (H * D + M), dtype=torch.int32, device=dev)
        err = lib.bal_scores_heavy(*args, H, *(p(t) for t in overflow), M,
                                   p(tab), p(rel), p(tgt),
                                   _build.stream_of(ell_idx))
        _build.check(err, "bal_scores_heavy")
        _build.count_launch("bal_scores_heavy" + form)
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
    req = _build.require
    req("greedy_pick vals", vals, torch.float32, (M,), dev)
    req("greedy_pick tgt_blk", tgt_blk, torch.int32, (M,), dev)
    req("greedy_pick src_blk", src_blk, torch.int32, (M,), dev)
    req("greedy_pick cand_w", cand_w, torch.int32, (M,), dev)
    req("greedy_pick block_w", block_w, torch.int32, (K,), dev)
    req("greedy_pick l_max", l_max, torch.int32, (K,), dev)
    if K < 1:
        raise ValueError("greedy_pick: the block table is empty")
    lib = _build.load("bal_round", _SIG)
    accept = torch.empty(M, dtype=torch.bool, device=dev)
    bw = torch.empty(K, dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.greedy_pick(p(vals), p(tgt_blk), p(src_blk), p(cand_w),
                          p(block_w), p(l_max), M, K, p(accept), p(bw),
                          _build.stream_of(vals))
    _build.check(err, "greedy_pick")
    _build.count_launch("greedy_pick")
    return accept, bw


def smem_load_cycles(device, steps: int = 4096) -> float:
    """Clock cycles of one dependent shared-memory load on ``device`` (a
    pointer chase of ``steps`` loads by one thread): the latency of one
    step of ``greedy_pick``'s walk, which its bound counts. Waits for the
    stream."""
    lib = _build.load("bal_round", _SIG)
    out = torch.zeros(2, dtype=torch.int64, device=device)
    _build.check(lib.smem_chase_cycles(steps, _build.ptr(out),
                                       _build.stream_of(out)),
                 "smem_chase_cycles")
    return int(out[0]) / steps
