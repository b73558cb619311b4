"""The size-constrained LP refinement of the partitioner's default
``refine="lp"`` (dKaMinPar, arXiv:2303.01417, section 4), in plain
PyTorch: restore feasibility, refine in chunks, restore again. A request's
refinement mode names its module here, ``refine_<mode>.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .plain import (CSR, I32_MAX, argmax_target, arc_chunks, chunk_salts,
                    group_conns, on, own_connection, pad_blocks, rebalance,
                    segment_sum, sorted_slab, visit_permutation)


def refine_chunk(labels, block_w, l_max, parent, c_src, c_dst, c_w,
                 vweights, salt, n, restricted):
    """One chunk of refinement: a vertex moves to the adjacent block that
    has room and it is most connected to, on a positive gain, or on a zero
    gain into a lighter block."""
    s_src, s_lab, s_w = sorted_slab(labels, c_src, c_dst, c_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = group_conns(s_src, s_lab, s_w)
    own_lab = labels[src_i]
    staying = s_lab == own_lab
    fits = (block_w[lab_i] <= l_max[lab_i] - vweights[src_i]) & ~staying
    if restricted:
        fits &= parent[lab_i] == parent[own_lab.long()]
    score = torch.where(fits, conn, -1)
    best, target = argmax_target(s_src, s_lab, score, block_w[lab_i], salt,
                                 n)
    gain = best - own_connection(s_src, s_lab, s_w, labels, n)
    tgt_safe = torch.where(target < I32_MAX, target, 0)
    lighter = block_w[tgt_safe.long()] < block_w[labels.long()] - vweights
    move = (target < I32_MAX) & (best >= 0) & \
        ((gain > 0) | ((gain == 0) & lighter))
    move[n] = False
    vw_moved = torch.where(move, vweights, 0)
    k = block_w.shape[0]
    d_in = segment_sum(vw_moved, torch.where(move, tgt_safe, 0).long(), k)
    d_out = segment_sum(vw_moved, torch.where(move, labels, 0).long(), k)
    return torch.where(move, tgt_safe, labels), block_w + d_in - d_out


def lp_refine(g, part, l_max_vec, parent, num_iterations, num_chunks, seed,
              dev) -> np.ndarray:
    g = CSR.of(g)
    n, k = g.n, int(l_max_vec.shape[0])
    if n == 0 or k <= 1:
        return part
    perm, g2 = visit_permutation(g, seed)
    part2 = np.empty(n, dtype=np.int64)
    part2[perm] = part
    s, d, w, n_pad = arc_chunks(g2, num_chunks)
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:n] = part2
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:n] = g2.vweights
    block_w = np.bincount(part, weights=g.vweights, minlength=k)
    bw, lv, pr = pad_blocks(np.rint(block_w).astype(np.int64), l_max_vec,
                            parent)
    labels_t, bw_t = on(labels, dev), on(bw, dev)
    lv_t, pr_t, vw_t = on(lv, dev), on(pr, dev), on(vw, dev)
    s, d, w = on(s, dev), on(d, dev), on(w, dev)
    for it in range(num_iterations):
        salt0 = (seed * 2654435761 + it) % 2**32
        for b, salt in enumerate(chunk_salts(s.shape[0], salt0,
                                             0xC2B2AE35)):
            labels_t, bw_t = refine_chunk(labels_t, bw_t, lv_t, pr_t, s[b],
                                          d[b], w[b], vw_t, salt, n_pad,
                                          parent is not None)
    return labels_t[:n].cpu().numpy().astype(np.int64)[perm]


def balance_and_refine(g, part, l_max_vec, parent, num_iterations,
                       num_chunks, seed, dev):
    """Restore feasibility, refine by size-constrained LP, restore again."""
    part = rebalance(g, part, l_max_vec, parent=parent, seed=seed, dev=dev)
    part = lp_refine(g, part, l_max_vec, parent, num_iterations, num_chunks,
                     seed, dev)
    return rebalance(g, part, l_max_vec, parent=parent, seed=seed + 1,
                     dev=dev)
