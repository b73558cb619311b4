"""Plain-PyTorch versions of the balance-round CUDA kernels.

``bal_scores_ell_ref`` is the ``bal_scores`` kernel's function: the
gathers of the per-lane and per-row operands from the ELL ids and the
block tables, then ``bal_scores_ref`` on them. ``bal_scores_ref`` (the TPU
kernel's pre-gathered form) and ``greedy_pick_ref`` (the sequential walk)
are the JAX package's ``bal_scores_ref`` / ``greedy_pick_ref`` op for op.
The wrappers run them for CPU tensors; the chip check holds the kernels to
them.
"""
from __future__ import annotations

import torch

from ..lp_move.ref import ell_conn, tie_chain

NEG_INF = float("-inf")


def bal_scores_ref(nlab, nw, nbw, nlm, own, vw, ovr, vld, fb_t, fb_ok,
                   salt: int, npar=None, opar=None):
    """``(rel, tgt)``: (R,) f32 relative gains and (R,) int32 targets.
    nlab/nw/nbw/nlm[/npar] are (R, D) int32, the rest (R,) int32;
    ``npar is None`` selects the unrestricted form."""
    validn = nlab >= 0
    ok = (nbw <= (nlm - vw[:, None])) & (nlab != own[:, None]) & validn
    if npar is not None:
        ok &= npar == opar[:, None]
    score = torch.where(ok, ell_conn(nlab, nw), -1)
    best, _, tgt_adj = tie_chain(score, nbw, nlab, salt)
    own_conn = torch.where((nlab == own[:, None]) & validn, nw, 0).sum(1) \
        .to(torch.int32)
    has_adj = best >= 0
    g = torch.where(has_adj, best - own_conn, -own_conn)
    tgt = torch.where(has_adj, tgt_adj, fb_t)
    movable = (ovr != 0) & (has_adj | (fb_ok != 0)) & (vld != 0)
    # the reference's f32 op order: convert, max with 1, one mul or div
    gf = g.to(torch.float32)
    cv = torch.clamp(vw.to(torch.float32), min=1.0)
    rel = torch.where(g >= 0, gf * cv, gf / cv)
    return torch.where(movable, rel, NEG_INF), tgt


def bal_scores_ell_ref(ell_idx, ell_w, labels, vw, block_w, l_max,
                       fb_of_block, n: int, salt: int, parent=None):
    """``(rel, tgt)`` of the rows of an ELL graph: ``ell_idx`` / ``ell_w``
    (R, D) int32 neighbour rows and arc weights (-1 / 0 padding),
    ``labels`` / ``vw`` (R,) int32 block and vertex weight of each row,
    ``block_w`` / ``l_max`` / ``fb_of_block`` (K,) int32 block weights,
    budgets and fallback targets; rows ``r >= n`` never move. ``parent``
    (K,) selects the restricted form. The operands of ``bal_scores_ref``
    are gathered here as the fused round gathered them for the TPU
    kernel."""
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
    return bal_scores_ref(nlab, ell_w, block_w[nl], l_max[nl], labels, vw,
                          over_own.to(torch.int32), vld.to(torch.int32),
                          fb_t, fb_ok.to(torch.int32), salt, **kw)


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
