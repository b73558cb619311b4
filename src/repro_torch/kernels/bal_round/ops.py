"""Host-side ELL construction + round of the fused balancer.

``core.balance.rebalance`` feeds the composed round a single-chunk arc
slab, sorted per round. The fused round takes the graph in ELL form once,
one row per label-table slot ``0 .. n_pad`` and D warp-padded neighbor
lanes; the per-round work is torch gathers plus the two kernels. The
sentinel and padded rows carry no arcs and are masked by the ``valid``
column exactly as the composed path masks them, so (labels, block_w)
trajectories are bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.lp import I32_MAX, segment_min
from ..lp_move.ops import LANE, _round_up, ell_from_csr
from .bal_round import bal_scores, greedy_pick


def build_balance_ell(g, n_pad: int):
    """(n_pad + 1, D) neighbor-id / weight ELL over the label-table row
    space; -1 / 0 padding."""
    deg = np.diff(g.indptr)
    D = _round_up(int(deg.max()) if deg.size else 1, LANE)
    idx = np.full((n_pad + 1, D), -1, dtype=np.int32)
    w = np.zeros((n_pad + 1, D), dtype=np.int32)
    idx_full, w_full = ell_from_csr(np.asarray(g.indptr),
                                    np.asarray(g.adjncy, dtype=np.int64),
                                    np.asarray(g.eweights), D)
    idx[:g.n] = idx_full
    w[:g.n] = w_full
    return idx, w


def fallback_target(block_w, parent, lab_src, restricted: bool):
    """Lightest-block fallback target per row: the lightest block overall,
    or (restricted) the lightest sibling within the own parent group;
    ties to the smaller block id."""
    k = block_w.shape[0]
    ids = torch.arange(k, dtype=torch.int32, device=block_w.device)
    if restricted:
        p = parent.long()
        grp_min = segment_min(block_w, p, k)
        bid = torch.where(block_w == grp_min[p], ids, I32_MAX)
        grp_argmin = segment_min(bid, p, k)
        return grp_argmin[parent[lab_src.long()].long()]
    first_min = torch.where(block_w == block_w.min(), ids, I32_MAX).min()
    return first_min.expand(lab_src.shape[0])


def fused_round_scores(labels, bw, l_max, parent, ell_idx, ell_w, vw_pad,
                       vld, salt: int, *, restricted: bool):
    """Gather the ELL operands + run ``bal_scores``. Fallback target /
    feasibility columns are composed exactly as
    ``core.balance.balance_gains`` composes them."""
    valid_l = ell_idx >= 0
    nlab = torch.where(valid_l, labels[torch.where(valid_l, ell_idx, 0)
                                       .long()], -1)
    nl = torch.where(valid_l, nlab, 0).long()
    lab_i = labels.long()
    over_own = bw[lab_i] > l_max[lab_i]
    fb_t = fallback_target(bw, parent, labels, restricted)
    fb_ok = (bw[fb_t.long()] <= l_max[fb_t.long()] - vw_pad) & \
        (fb_t != labels)
    kw = {}
    if restricted:
        kw = dict(npar=parent[nl], opar=parent[lab_i])
    return bal_scores(nlab, ell_w, bw[nl], l_max[nl], labels, vw_pad,
                      over_own.to(torch.int32), vld.to(torch.int32),
                      fb_t.contiguous(), fb_ok.to(torch.int32), salt, **kw)


def balance_round_fused(labels, block_w, l_max, parent, ell_idx, ell_w,
                        vweights, valid, salt: int, *, top_m: int,
                        restricted: bool = False):
    """Fused twin of ``core.balance.balance_round``: same pool ranking,
    same accept rule, bit-identical (labels, block_w) trajectory. Updates
    ``labels`` in place and returns it."""
    rel, tgt = fused_round_scores(labels, block_w, l_max, parent, ell_idx,
                                  ell_w, vweights, valid, salt,
                                  restricted=restricted)
    # lax.top_k order: descending, ties to the lower index (torch.topk
    # breaks ties differently; a stable descending sort does not)
    vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
    t_v, l_v = tgt[vidx], labels[vidx]
    accept, block_w = greedy_pick(rel[vidx], t_v, l_v, vweights[vidx],
                                  block_w, l_max)
    labels[vidx] = torch.where(accept, t_v, l_v)
    return labels, block_w, bool((block_w > l_max).any())
