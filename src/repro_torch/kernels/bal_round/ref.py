"""Plain-PyTorch versions of the balance-round CUDA kernels.

``bal_scores_ell_ref`` is the ``bal_scores`` kernel's function: the
gathers of the per-lane and per-row operands from the ELL ids and the
block tables, then ``bal_scores_ref`` on them. ``bal_scores_ref`` (the TPU
kernel's pre-gathered form) and ``greedy_pick_ref`` (the sequential walk)
are the JAX package's ``bal_scores_ref`` / ``greedy_pick_ref`` op for op.
The wrappers run them for CPU tensors; the chip check holds the kernels to
them.

``bal_scores_ell_ref`` takes the kernel's split form: the heavy rows of a
capped ELL slab have arcs beyond it (``overflow``), and their best
admissible block comes from the distinct blocks of the whole row
(``heavy_adjacent_ref``), as the kernel's heavy-row path computes it.
"""
from __future__ import annotations

import torch

from ...core.lp import _argmax_target, segment_sum
from ..lp_move.ref import ell_conn, heavy_arcs, label_groups, tie_chain

NEG_INF = float("-inf")


def adjacent_ref(nlab, nw, nbw, nlm, own, vw, salt: int, npar=None,
                 opar=None):
    """``(best, tgt_adj, own_conn)`` per row: the best admissible
    neighbour block's connectivity (< 0: none) and label, and the own
    block's connectivity."""
    validn = nlab >= 0
    ok = (nbw <= (nlm - vw[:, None])) & (nlab != own[:, None]) & validn
    if npar is not None:
        ok &= npar == opar[:, None]
    score = torch.where(ok, ell_conn(nlab, nw), -1)
    best, _, tgt_adj = tie_chain(score, nbw, nlab, salt)
    own_conn = torch.where((nlab == own[:, None]) & validn, nw, 0).sum(1) \
        .to(torch.int32)
    return best, tgt_adj, own_conn


def heavy_adjacent_ref(ell_idx, ell_w, labels, vw, block_w, l_max, salt,
                       parent, overflow):
    """``adjacent_ref`` of the heavy rows over their whole rows: ``(rows,
    best, tgt_adj, own_conn)``. ``overflow`` is ``(rows, ptr, idx, w)``,
    the arcs of rows ``rows`` beyond their slab lanes (the plan after
    them, if given, is the kernel's: this version splits the rows by
    ``heavy.lane_items`` itself and sums the parts)."""
    rows, ptr, o_idx, o_w = overflow[:4]
    H = rows.shape[0]
    hid, item, (ids, w) = heavy_arcs(rows, ptr, (ell_idx, ell_w),
                                     (o_idx, o_w))
    g_row, g_lab, _, conn = label_groups(hid, item, labels[ids.long()], w)
    lab = g_lab.long()
    r_own, r_vw = labels[rows.long()], vw[rows.long()]
    own_g = r_own[g_row]
    ok = (block_w[lab] <= (l_max[lab] - r_vw[g_row])) & (g_lab != own_g)
    if parent is not None:
        ok &= parent[lab] == parent[own_g.long()]
    score = torch.where(ok, conn, -1)
    best, tgt = _argmax_target(g_row, g_lab, score, block_w[lab], salt,
                               H - 1)
    own_conn = segment_sum(torch.where(g_lab == own_g, conn, 0), g_row, H)
    return rows.long(), best, tgt, own_conn


def scores_from_adjacent(best, tgt_adj, own_conn, vw, ovr, vld, fb_t,
                         fb_ok):
    """``(rel, tgt)`` from ``adjacent_ref``'s per-row results."""
    has_adj = best >= 0
    g = torch.where(has_adj, best - own_conn, -own_conn)
    tgt = torch.where(has_adj, tgt_adj, fb_t)
    movable = (ovr != 0) & (has_adj | (fb_ok != 0)) & (vld != 0)
    # the reference's f32 op order: convert, max with 1, one mul or div
    gf = g.to(torch.float32)
    cv = torch.clamp(vw.to(torch.float32), min=1.0)
    rel = torch.where(g >= 0, gf * cv, gf / cv)
    return torch.where(movable, rel, NEG_INF), tgt


def bal_scores_ref(nlab, nw, nbw, nlm, own, vw, ovr, vld, fb_t, fb_ok,
                   salt: int, npar=None, opar=None):
    """``(rel, tgt)``: (R,) f32 relative gains and (R,) int32 targets.
    nlab/nw/nbw/nlm[/npar] are (R, D) int32, the rest (R,) int32;
    ``npar is None`` selects the unrestricted form."""
    return scores_from_adjacent(
        *adjacent_ref(nlab, nw, nbw, nlm, own, vw, salt, npar, opar), vw,
        ovr, vld, fb_t, fb_ok)


def bal_scores_ell_ref(ell_idx, ell_w, labels, vw, block_w, l_max,
                       fb_of_block, n: int, salt: int, parent=None,
                       overflow=None, dist: bool = False):
    """``(rel, tgt)`` of the rows of an ELL graph: ``ell_idx`` / ``ell_w``
    (R, D) int32 neighbour rows and arc weights (-1 / 0 padding),
    ``labels`` / ``vw`` (R,) int32 block and vertex weight of each row,
    ``block_w`` / ``l_max`` / ``fb_of_block`` (K,) int32 block weights,
    budgets and fallback targets; rows ``r >= n`` never move. ``parent``
    (K,) selects the restricted form. The operands of ``bal_scores_ref``
    are gathered here as the fused round gathered them for the TPU
    kernel. ``overflow``: ``(rows, ptr, idx, w)`` int32, the arcs of the
    heavy rows beyond their slab lanes (``lp_move.ops.Overflow``), or
    None. ``dist`` is the wrapper's (it names the launch counter) and
    changes nothing."""
    valid_l = ell_idx >= 0
    nlab = torch.where(valid_l, labels[torch.where(valid_l, ell_idx, 0)
                                       .long()], -1)
    nl = torch.where(valid_l, nlab, 0).long()
    lab_i = labels.long()
    over_own = block_w[lab_i] > l_max[lab_i]
    fb_t = fb_of_block[lab_i]
    fb_l = fb_t.long()
    fb_ok = (block_w[fb_l] <= l_max[fb_l] - vw) & (fb_t != labels)
    vld = torch.arange(labels.shape[0], device=labels.device) < n
    kw = {}
    if parent is not None:
        kw = dict(npar=parent[nl], opar=parent[lab_i])
    best, tgt_adj, own_conn = adjacent_ref(
        nlab, ell_w, block_w[nl], l_max[nl], labels, vw, salt, **kw)
    if overflow is not None and overflow[0].shape[0]:
        rows, b_h, t_h, o_h = heavy_adjacent_ref(
            ell_idx, ell_w, labels, vw, block_w, l_max, salt, parent,
            overflow)
        best[rows], tgt_adj[rows], own_conn[rows] = b_h, t_h, o_h
    return scores_from_adjacent(best, tgt_adj, own_conn, vw,
                                over_own.to(torch.int32),
                                vld.to(torch.int32), fb_t,
                                fb_ok.to(torch.int32))


def greedy_pick_ref(vals, tgt_blk, src_blk, cand_w, block_w, l_max):
    """Sequential greedy application of a ranked pool: ``(accept, bw)``,
    (M,) bool and the updated (K,) int32 block-weight table."""
    vals_l = vals.tolist()
    t_l, b_l, c_l = tgt_blk.tolist(), src_blk.tolist(), cand_w.tolist()
    bw = block_w.tolist()
    lm = l_max.tolist()
    K = len(bw)
    accept = []

    def wrap(x):     # int32 arithmetic wraps, as the device's does
        return (x + 2**31) % 2**32 - 2**31

    for v, t, b, c in zip(vals_l, t_l, b_l, c_l):
        tc, bc = min(max(t, 0), K - 1), min(max(b, 0), K - 1)
        ok = v > NEG_INF and bw[bc] > lm[bc] and bw[tc] <= wrap(lm[tc] - c) \
            and t != b
        if ok:
            if 0 <= b < K:
                bw[b] = wrap(bw[b] - c)
            if 0 <= t < K:
                bw[t] = wrap(bw[t] + c)
        accept.append(ok)
    dev = block_w.device
    return (torch.tensor(accept, dtype=torch.bool, device=dev),
            torch.tensor(bw, dtype=torch.int32, device=dev))
