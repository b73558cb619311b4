"""Greedy global balancing (paper §4, Balancing) — port of
``repro.core.balance``.

Per round: relative gains of every vertex of an overloaded block
(``balance_gains``), a pool of the ``top_m`` best candidates in
``lax.top_k`` order, and the deterministic greedy application of that pool
against the block-weight table (``greedy_select``). Relative gain (paper):
g·c(v) if g >= 0 else g/c(v), in f32 in the reference's op order, where g
is the best cut reduction over targets that would not become overloaded;
the lightest block is the fallback target of a vertex without an
admissible neighbor, which guarantees termination.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..graphs.format import Graph
from ..kernels import dispatch
from ..kernels.bal_round.ops import fallback_table
from ..kernels.bal_round.ref import NEG_INF, greedy_pick_ref
from . import lp
from .lp import I32_MAX, _argmax_target, _group_conns, _own_connection


def balance_gains(lab_src_tab, s_src, s_lab, s_w, block_w, l_max, parent,
                  vw_pad, salt, n, valid, restricted=False):
    """Per-vertex relative gains + targets for one balancing round over an
    arc slab sorted by (src, label[dst]); ``lab_src_tab``/``vw_pad``/
    ``valid`` live over the (n+1,) src space (slot n is the sentinel).
    Returns ``(rel, tgt)``: NEG_INF where the vertex must not move."""
    over = block_w > l_max
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = lab_src_tab[src_i]
    fits = block_w[lab_i] <= l_max[lab_i] - vw_pad[src_i]
    ok = fits & (s_lab != own_lab)
    if restricted:
        ok &= parent[lab_i] == parent[own_lab.long()]
    score = torch.where(ok, conn, -1)
    best, target = _argmax_target(s_src, s_lab, score, block_w[lab_i],
                                  salt, n)
    own_conn = _own_connection(s_src, s_lab, s_w, lab_src_tab, n)

    has_adj = (best >= 0) & (target < I32_MAX)
    tgt_adj = torch.where(has_adj, target, 0)
    gain_adj = best - own_conn
    fb_t = fallback_table(block_w, parent, restricted)[lab_src_tab.long()]
    fb_l = fb_t.long()
    fb_ok = (block_w[fb_l] <= l_max[fb_l] - vw_pad) & (fb_t != lab_src_tab)

    tgt = torch.where(has_adj, tgt_adj, fb_t)
    g = torch.where(has_adj, gain_adj, -own_conn)
    movable = over[lab_src_tab.long()] & (has_adj | fb_ok) & valid

    gf = g.to(torch.float32)
    cv = torch.clamp(vw_pad.to(torch.float32), min=1.0)
    rel = torch.where(g >= 0, gf * cv, gf / cv)
    return torch.where(movable, rel, NEG_INF), tgt


def greedy_select(vals, tgt_blk, src_blk, cand_w, block_w, l_max):
    """Deterministic greedy application of a ranked candidate pool
    (ordered by descending relative gain, ties by ascending vertex id).
    Returns ``(accept, block_w)``. A sequential walk of M steps: the
    plain version of the ``greedy_pick`` kernel."""
    return greedy_pick_ref(vals, tgt_blk, src_blk, cand_w, block_w, l_max)


def balance_round(labels, block_w, l_max, parent, src, dst, w, vweights,
                  valid, salt, *, n, top_m, restricted=False):
    """One global balancing round. Returns (labels, block_w,
    still_overloaded); updates ``labels`` in place. Arrays over vertices
    have size n+1 (sentinel slot n); ``valid`` marks the real ones."""
    lab_dst = labels[dst.long()]
    order = lp.sort2(src, lab_dst)
    rel, tgt = balance_gains(labels, src[order], lab_dst[order], w[order],
                             block_w, l_max, parent, vweights, salt, n,
                             valid, restricted=restricted)
    # lax.top_k order: descending, ties to the lower index
    vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
    t_v, l_v = tgt[vidx], labels[vidx]
    accept, block_w = greedy_select(rel[vidx], t_v, l_v, vweights[vidx],
                                    block_w, l_max)
    labels[vidx] = torch.where(accept, t_v, l_v)
    return labels, block_w, bool((block_w > l_max).any())


def rebalance(g: Graph,
              part: np.ndarray,
              l_max_vec: np.ndarray,
              parent: Optional[np.ndarray] = None,
              top_m: int = 128,
              max_rounds: int = 200,
              seed: int = 0,
              kernel: str = "auto",
              stats: Optional[Dict] = None,
              device=None) -> np.ndarray:
    """Host loop: run balance rounds until feasible. ``part`` is (n,)
    block ids; ``l_max_vec`` is (k,) per-block budgets.

    Already-feasible partitions return immediately without building slabs
    or touching the device. ``kernel="fused"`` runs the round through the
    ``bal_scores`` / ``greedy_pick`` kernels (bit-identical to the composed
    round). ``stats``, when given, receives ``rounds`` / ``time_s`` /
    ``gather_bytes``."""
    dev = dispatch.resolve_device(device)
    n = g.n
    k = int(l_max_vec.shape[0])
    t_start = time.perf_counter()
    from . import metrics
    block_w = metrics.block_weights(g, part, k)
    if not bool(np.any(block_w > l_max_vec)):
        if stats is not None:
            stats.update(rounds=0, gather_bytes=0,
                         time_s=time.perf_counter() - t_start)
        return np.array(part, dtype=np.int64)   # fresh array, never a view
    chunks = lp.build_chunks(g, 1)
    n_pad = chunks.n_pad
    top_m = min(top_m, n_pad + 1)
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:n] = part
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:n] = g.vweights
    from .refinement import pad_blocks
    bw_p, lv_p, pr_p, _ = pad_blocks(block_w, l_max_vec, parent)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    labels_t = on_dev(labels)
    vw_t = on_dev(vw)
    block_w_t = on_dev(bw_p)
    l_max_t = on_dev(lv_p)
    parent_t = on_dev(pr_p)
    valid = on_dev(np.arange(n_pad + 1) < n)
    restricted = parent is not None
    fused_ell = None
    if dispatch.resolve_kernel_mode(kernel, dev) == "fused":
        from ..kernels.bal_round import ops as bal_ops
        idx, ew, ov = bal_ops.build_balance_ell(g, n_pad, device=dev)
        fused_ell = (on_dev(idx), on_dev(ew),
                     None if ov is None else tuple(on_dev(x) for x in ov))
    else:
        src, dst, w = (on_dev(x[0]) for x in (chunks.src, chunks.dst,
                                               chunks.w))
    rounds = 0
    for r in range(max_rounds):
        salt = (seed * 7919 + r) % (2**32)
        if fused_ell is not None:
            labels_t, block_w_t, overloaded = bal_ops.balance_round_fused(
                labels_t, block_w_t, l_max_t, parent_t, fused_ell[0],
                fused_ell[1], vw_t, n, salt, top_m=top_m,
                restricted=restricted, overflow=fused_ell[2])
        else:
            labels_t, block_w_t, overloaded = balance_round(
                labels_t, block_w_t, l_max_t, parent_t, src, dst, w, vw_t,
                valid, salt, n=n_pad, top_m=top_m, restricted=restricted)
        rounds = r + 1
        if not overloaded:
            break
    if stats is not None:
        stats.update(rounds=rounds,
                     gather_bytes=int(chunks.src.nbytes + chunks.dst.nbytes
                                      + chunks.w.nbytes),
                     time_s=time.perf_counter() - t_start)
    return labels_t[:n].cpu().numpy().astype(np.int64)
