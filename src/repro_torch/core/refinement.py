"""k-way refinement (paper §4 + the unconstrained tier) — port of
``repro.core.refinement``.

``balance_and_refine`` is the per-level entry point: restore feasibility,
improve, re-restore. The improvement pass is selected by the ``refine``
knob — ``"lp"`` (default) is the paper's size-constrained LP;
``"unconstrained"`` is the Jet-style penalty-weighted search of
``core.unconstrained``, whose trailing rebalance acts as the feasibility
*afterburner*. Either way it never returns an infeasible partition.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graphs.format import Graph, degree_bucket_order, permute
from ..kernels import dispatch
from . import balance as bal
from . import lp

_BIG_L = np.int32(2**31 - 1)


def pad_blocks(block_w: np.ndarray, l_max_vec: np.ndarray,
               parent: Optional[np.ndarray], min_bucket: int = 64
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad the block count to a power-of-two bucket (>= min_bucket) with
    unreachable dummy blocks: they carry the maximal int32 weight (never
    the lightest-block fallback), the same maximal budget (never
    overloaded, never a fitting target) and are adjacent to no vertex.
    Every table then has the reference's shape. Block weights must fit
    int32, else ``ValueError``."""
    k = int(block_w.shape[0])
    if np.any(block_w.astype(np.int64) > int(_BIG_L)) or \
            np.any(block_w.astype(np.int64) < 0):
        raise ValueError(
            "pad_blocks: block weights must fit int32 (max "
            f"{int(block_w.max())}); totals >= 2^31 are not supported by "
            "the int32 device path")
    k_pad = max(min_bucket, 1 << max(0, (k - 1)).bit_length())
    if k_pad == k:
        p = parent if parent is not None else np.arange(k)
        return (block_w.astype(np.int32),
                np.minimum(l_max_vec, _BIG_L).astype(np.int32),
                p.astype(np.int32), k)
    bw = np.full(k_pad, _BIG_L, dtype=np.int32)
    bw[:k] = block_w
    lv = np.full(k_pad, _BIG_L, dtype=np.int32)
    lv[:k] = np.minimum(l_max_vec, _BIG_L)
    pr = np.arange(k_pad, dtype=np.int32)
    if parent is not None:
        pr[:k] = parent
    else:
        pr[:k] = np.arange(k)
    return bw, lv, pr, k


def lp_refine(g: Graph,
              part: np.ndarray,
              l_max_vec: np.ndarray,
              parent: Optional[np.ndarray] = None,
              num_iterations: int = 2,
              num_chunks: int = 8,
              seed: int = 0,
              device=None) -> np.ndarray:
    """Chunked size-constrained LP refinement (torch ops on ``device``)."""
    dev = dispatch.resolve_device(device)
    n = g.n
    k = int(l_max_vec.shape[0])
    if n == 0 or k <= 1:
        return part
    rng = np.random.default_rng(seed)
    order = degree_bucket_order(g, rng)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    g2, _ = permute(g, perm)
    part2 = np.empty(n, dtype=np.int64)
    part2[perm] = part  # part2[new_id] = part[old_id]
    chunks = lp.build_chunks(g2, num_chunks)
    n_pad = chunks.n_pad
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:n] = part2
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:n] = g2.vweights
    block_w = np.zeros(k, dtype=np.int64)
    np.add.at(block_w, part, g.vweights)
    bw_p, lv_p, pr_p, _ = pad_blocks(block_w, l_max_vec, parent)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    labels_t, block_w_t = on_dev(labels), on_dev(bw_p)
    args = [on_dev(x) for x in (lv_p, pr_p, chunks.src, chunks.dst,
                                chunks.w, vw)]
    for it in range(num_iterations):
        labels_t, block_w_t = lp.refine_iteration(
            labels_t, block_w_t, *args, (seed * 2654435761 + it) % (2**32),
            n=n_pad, restricted=parent is not None)
    out2 = labels_t[:n].cpu().numpy().astype(np.int64)
    return out2[perm]  # back to original ids: part[old] = out2[perm[old]]


REFINE_MODES = ("lp", "unconstrained")


def check_refine_mode(refine: str) -> str:
    if refine not in REFINE_MODES:
        raise ValueError(f"unknown refine mode {refine!r}; expected one "
                         f"of {REFINE_MODES}")
    return refine


def balance_and_refine(g: Graph,
                       part: np.ndarray,
                       l_max_vec: np.ndarray,
                       parent: Optional[np.ndarray] = None,
                       num_iterations: int = 2,
                       num_chunks: int = 8,
                       seed: int = 0,
                       kernel: str = "auto",
                       refine: str = "lp",
                       stats: Optional[Dict] = None,
                       device=None) -> np.ndarray:
    """Paper's BalanceAndRefine: restore feasibility, improve, re-restore.

    ``refine="unconstrained"`` swaps the improvement pass for the
    penalty-weighted unconstrained search; the trailing rebalance then
    acts as the feasibility afterburner, so the result satisfies the
    budgets under either mode. ``stats`` (unconstrained mode only)
    receives the ``penalty`` schedule and the afterburner's
    ``repair_rounds``."""
    check_refine_mode(refine)
    part = bal.rebalance(g, part, l_max_vec, parent=parent, seed=seed,
                         kernel=kernel, device=device)
    if refine == "unconstrained":
        from .unconstrained import unconstrained_refine
        part = unconstrained_refine(g, part, l_max_vec, parent=parent,
                                    num_iterations=num_iterations,
                                    num_chunks=num_chunks, seed=seed,
                                    stats=stats, device=device)
        repair: Dict = {}
        part = bal.rebalance(g, part, l_max_vec, parent=parent,
                             seed=seed + 1, kernel=kernel, stats=repair,
                             device=device)
        if stats is not None:
            stats["repair_rounds"] = repair.get("rounds")
        return part
    part = lp_refine(g, part, l_max_vec, parent=parent,
                     num_iterations=num_iterations,
                     num_chunks=num_chunks, seed=seed, device=device)
    return bal.rebalance(g, part, l_max_vec, parent=parent, seed=seed + 1,
                         kernel=kernel, device=device)
