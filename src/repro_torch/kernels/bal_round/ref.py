"""Plain-PyTorch versions of the balance-round CUDA kernels.

``bal_scores_ref`` follows the kernel's per-row ELL form and
``greedy_pick_ref`` its sequential walk; both are the JAX package's
``bal_scores_ref`` / ``greedy_pick_ref`` op for op. The wrappers run them
for CPU tensors; the chip check holds the kernels to them.
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
