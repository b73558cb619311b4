"""Unconstrained (Jet-style) k-way refinement with penalty-weighted gains —
port of ``repro.core.unconstrained``.

The second refinement tier behind ``PartitionerConfig(refine=
"unconstrained")``: moves may overload a block during the pass, so the
search escapes the local optima of the size-constrained LP rule
(``core.lp._refine_chunk``). A move whose target block would end over its
budget is charged

    pen = (own_connection // R) * r          (round r of R, integer math)

so round 0 is pure gain-greedy and later rounds ask overloading moves for
ever more gain. ``refinement.balance_and_refine`` restores feasibility
afterwards with the balancer (the *afterburner*), so its callers never see
an infeasible result. Everything else — the sorted arc slabs, the
4-stage argmax tie-break, the zero-gain-into-lighter-block rule, the salt
streams — is ``core.lp``'s; the reference has no kernel for this tier, so
it runs as torch ops on ``device``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..graphs.format import Graph, degree_bucket_order, permute
from ..kernels import dispatch
from . import lp
from .lp import (I32_MAX, _argmax_target, _group_conns, _own_connection,
                 _sorted_slab, segment_sum)


def penalty_schedule(num_iterations: int) -> list:
    """The escalating per-round penalty fractions ``r / R`` (round 0 is
    fully unconstrained), as the trace records them."""
    R = max(1, int(num_iterations))
    return [round(r / R, 4) for r in range(R)]


def _urefine_chunk(labels, block_w, l_max, parent, chunk_src, chunk_dst,
                   chunk_w, vweights, salt, pen_num, pen_den, n,
                   restricted):
    """One chunk of unconstrained LP refinement over k blocks.

    ``lp._refine_chunk`` with the budget mask replaced: candidates whose
    target would end over budget pay ``(own_conn // pen_den) * pen_num``
    off their connection before the argmax (``pen_num`` / ``pen_den``
    plain ints), and the block weights track the possibly overloaded
    truth. ``restricted`` confines moves to sibling blocks."""
    s_src, s_lab, s_w = _sorted_slab(labels, chunk_src, chunk_dst, chunk_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = labels[src_i]
    staying = s_lab == own_lab
    own_conn = _own_connection(s_src, s_lab, s_w, labels, n)
    # would the target overflow its budget after taking this vertex?
    # (``w > budget - c`` form: exact at the int32 boundary, where padded
    # blocks carry a 2^31-1 budget)
    over_after = block_w[lab_i] > l_max[lab_i] - vweights[src_i]
    # own_conn >= 0, so floor division is JAX's
    pen = torch.where(over_after,
                      (own_conn[src_i] // int(pen_den)) * int(pen_num), 0)
    ok = ~staying
    if restricted:
        ok &= parent[lab_i] == parent[own_lab.long()]
    # a candidate scoring below 0 can never pass the move rule (it would
    # need score >= own_conn >= 0), so clamping to -1 loses nothing
    score = torch.where(ok, torch.clamp(conn - pen, min=-1), -1)
    best, target = _argmax_target(s_src, s_lab, score, block_w[lab_i],
                                  salt, n)
    gain = best - own_conn
    tgt_safe = torch.where(target < I32_MAX, target, 0)
    lighter = block_w[tgt_safe.long()] < block_w[labels.long()] - vweights
    move = (target < I32_MAX) & (best >= 0) & \
        ((gain > 0) | ((gain == 0) & lighter))
    move[n] = False
    new_labels = torch.where(move, tgt_safe, labels)
    vw_moved = torch.where(move, vweights, 0)
    k = block_w.shape[0]
    d_in = segment_sum(vw_moved, torch.where(move, tgt_safe, 0).long(), k)
    d_out = segment_sum(vw_moved, torch.where(move, labels, 0).long(), k)
    return new_labels, block_w + d_in - d_out


def urefine_iteration(labels, block_w, l_max, parent, chunks_src,
                      chunks_dst, chunks_w, vweights, seed, pen_num,
                      pen_den, *, n, restricted=False):
    """One unconstrained refinement pass over all chunks; ``seed`` is the
    pass's uint32 salt base (the chunk salts are ``lp.refine_iteration``'s
    stream)."""
    B = chunks_src.shape[0]
    for b, salt in enumerate(lp.chunk_salts(B, seed, 0xC2B2AE35)):
        labels, block_w = _urefine_chunk(
            labels, block_w, l_max, parent, chunks_src[b], chunks_dst[b],
            chunks_w[b], vweights, salt, pen_num, pen_den, n, restricted)
    return labels, block_w


def unconstrained_refine(g: Graph,
                         part: np.ndarray,
                         l_max_vec: np.ndarray,
                         parent: Optional[np.ndarray] = None,
                         num_iterations: int = 2,
                         num_chunks: int = 8,
                         seed: int = 0,
                         stats: Optional[Dict] = None,
                         device=None) -> np.ndarray:
    """Chunked unconstrained refinement (torch ops on ``device``).

    ``refinement.lp_refine``'s skeleton — degree-bucket reorder, padded
    arc slabs, one ``urefine_iteration`` per round — but the result may
    exceed the per-block budgets; callers follow with ``balance.rebalance``
    (``balance_and_refine`` does). ``stats``, when given, receives the
    ``penalty`` schedule applied."""
    dev = dispatch.resolve_device(device)
    n = g.n
    k = int(l_max_vec.shape[0])
    if stats is not None:
        stats["penalty"] = penalty_schedule(num_iterations)
    if n == 0 or k <= 1 or num_iterations < 1:
        return part
    rng = np.random.default_rng(seed)
    order = degree_bucket_order(g, rng)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    g2, _ = permute(g, perm)
    part2 = np.empty(n, dtype=np.int64)
    part2[perm] = part
    chunks = lp.build_chunks(g2, num_chunks)
    n_pad = chunks.n_pad
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:n] = part2
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:n] = g2.vweights
    block_w = np.zeros(k, dtype=np.int64)
    np.add.at(block_w, part, g.vweights)
    from .refinement import pad_blocks   # deferred: refinement imports us
    bw_p, lv_p, pr_p, _ = pad_blocks(block_w, l_max_vec, parent)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    labels_t, block_w_t = on_dev(labels), on_dev(bw_p)
    args = [on_dev(x) for x in (lv_p, pr_p, chunks.src, chunks.dst,
                                chunks.w, vw)]
    for it in range(num_iterations):
        labels_t, block_w_t = urefine_iteration(
            labels_t, block_w_t, *args, (seed * 2654435761 + it) % (2**32),
            it, num_iterations, n=n_pad, restricted=parent is not None)
    out2 = labels_t[:n].cpu().numpy().astype(np.int64)
    return out2[perm]
