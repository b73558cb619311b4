"""Plain-PyTorch version of the ``lp_move`` CUDA kernel.

It follows the kernel's reformulation, not the composed sort path:
phase A per ELL row (label-equality connectivity, admission, the 4-stage
tie chain), phase B over the chunk with label-indexed weight tables and
one sort of the candidates by (target, rank, row), instead of the TPU
kernel's R x R pairwise masks. The wrapper runs it for CPU tensors, the
tests hold it bit-identical to the JAX package's ``lp_move_chunk_ref``,
and the chip check holds the kernel to it. Nothing on the CUDA path
calls it.

It takes the kernel's split form: a chunk's heavy rows have arcs beyond
the slab's D lanes (``overflow``), and their phase A runs over the
distinct labels of the whole row (``heavy_targets_ref``), as the kernel's
heavy-row path does, in either admission form (the distributed form's
overflow carries the labels' budgets too). As the kernel does, it sums a
label's weight (and takes its smallest cluster weight and budget) per
work item first, a warp-class row whole or one hub range
(``kernels/heavy.py``), then over the items of the row. The tie chain
is a total order over distinct labels and a label's connectivity is an
int32 sum, exact in any order, so the split gives what the whole row
gives.
"""
from __future__ import annotations

import torch

from ...core.lp import (I32_MAX, _argmax_target, cumsum32, hash32,
                        segment_min, segment_sum)
from ..heavy import lane_items

def ell_conn(nlab: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    """``conn[r, j] = sum_i nw[r, i] * [nlab[r, i] == nlab[r, j]]`` (int32):
    every lane gets the summed weight of the lanes of its row that carry
    its label. The sums are taken per (row, label) group rather than over
    the (R, D, D) equality cube, which costs D times the memory; integer
    sums are exact in any order."""
    R, D = nlab.shape
    rows = torch.arange(R, dtype=torch.int64, device=nlab.device)[:, None]
    key = (rows << 32) | (nlab.to(torch.int64) + 1)   # labels are >= -1
    _, grp = torch.unique(key, return_inverse=True)
    sums = torch.zeros(R * D, dtype=torch.int32, device=nlab.device)
    sums.index_add_(0, grp.reshape(-1), nw.reshape(-1))
    return sums[grp]


def tie_chain(score, weight_key, nlab, salt):
    """Row-wise argmax of ``score`` with ties to the lighter weight key,
    then the smaller ``hash32(label, salt)``, then the smaller label.
    Returns (best, light, target) per row."""
    best = score.max(1, keepdim=True).values
    is_best = score == best
    light = torch.where(is_best, weight_key, I32_MAX).min(
        1, keepdim=True).values
    is_best &= weight_key == light
    h = hash32(nlab, salt)
    hbest = torch.where(is_best, h, I32_MAX).min(1, keepdim=True).values
    is_best &= h == hbest
    tgt = torch.where(is_best, nlab, I32_MAX).min(1).values
    return best[:, 0], light[:, 0], tgt


def heavy_arcs(rows, ptr, slab, extra):
    """The arcs of heavy rows as flat (H-row index, values...) lists:
    each heavy row's D slab lanes of every (R, D) table in ``slab``
    followed by its overflow arcs (``ptr`` CSR offsets into each (M_ov,)
    array of ``extra``), lanes with a negative first value dropped; and
    each arc's work item (``heavy.lane_items``)."""
    H, D = rows.shape[0], slab[0].shape[1]
    dev = slab[0].device
    extra_n = (ptr[1:] - ptr[:-1]).long()
    hid = torch.cat([torch.arange(H, device=dev).repeat_interleave(D),
                     torch.arange(H, device=dev).repeat_interleave(extra_n)])
    pos = torch.cat([torch.arange(D, device=dev).repeat(H),
                     D + torch.arange(int(ptr[-1]), device=dev)
                     - ptr[:-1].long().repeat_interleave(extra_n)])
    item = lane_items(hid, pos, D + extra_n)
    vals = [torch.cat([s[rows.long()].reshape(-1), e])
            for s, e in zip(slab, extra)]
    keep = vals[0] >= 0
    return hid[keep], item[keep], [v[keep] for v in vals]


def label_groups(hid, item, lab, w, *mins):
    """Distinct (row, label) groups of flat arcs: ``(g_row, g_lab, gid,
    conn, mins...)``, ``gid`` each arc's group, ``conn`` each group's
    int32 weight sum and each of ``mins`` its smallest value, each summed
    (taken) per work item ``item`` first and then over the row's items,
    as the kernels do."""
    part = torch.stack([item.long(), hid.long(), lab.long()], 1)
    uniq, pid = torch.unique(part, dim=0, return_inverse=True)
    p_sum = segment_sum(w, pid, uniq.shape[0])
    p_mins = [segment_min(m, pid, uniq.shape[0]) for m in mins]
    key = (uniq[:, 1] << 32) | (uniq[:, 2] & 0xFFFFFFFF)
    g_key, gid_p = torch.unique(key, return_inverse=True)
    conn = segment_sum(p_sum, gid_p, g_key.shape[0])
    g_mins = [segment_min(m, gid_p, g_key.shape[0]) for m in p_mins]
    return ((g_key >> 32), (g_key & 0xFFFFFFFF).to(torch.int32),
            gid_p[pid], conn, *g_mins)


def heavy_targets_ref(nlab, nw, ncw, own, vw, W: int, salt: int,
                      overflow, nbud=None):
    """Phase A of the heavy rows over their whole rows: ``(rows, mv, tgt,
    light)``. ``overflow`` is ``(rows, ptr, nlab, nw, ncw)``, the kernel's
    overflow operands, with the arcs' budgets ``nbud`` as a sixth entry in
    the distributed admission form (``nbud`` the slab's), and the plan
    after them, which this version derives itself; the lanes of one
    label carry one cluster weight and one budget (``chunk_operands``
    gathers them by label), whose minimum is taken."""
    rows, ptr, o_lab, o_w, o_cw = overflow[:5]
    H = rows.shape[0]
    slab, extra = (nlab, nw, ncw), (o_lab, o_w, o_cw)
    if nbud is not None:
        slab, extra = slab + (nbud,), extra + (overflow[5],)
    hid, item, vals = heavy_arcs(rows, ptr, slab, extra)
    g_row, g_lab, _, conn, g_cw, *g_bud = label_groups(hid, item, *vals)
    r_own, r_vw = own[rows.long()], vw[rows.long()]
    stay = g_lab == r_own[g_row]
    if nbud is None:
        fits = ((g_cw + r_vw[g_row]) <= W) | stay
    else:
        fits = (g_cw <= (g_bud[0] - r_vw[g_row])) | stay
    score = torch.where(fits, conn, -1)
    best, tgt = _argmax_target(g_row, g_lab, score, g_cw, salt, H - 1)
    light = segment_min(torch.where(score == best[g_row], g_cw, I32_MAX),
                        g_row, H)
    own_conn = segment_sum(torch.where(stay, conn, 0), g_row, H)
    mv = (best > own_conn) & (tgt != r_own) & (tgt < I32_MAX) & (best > 0)
    return rows.long(), mv, torch.where(mv, tgt, r_own), light


def move_targets_ref(nlab, nw, ncw, own, vw, W: int, salt: int,
                     nbud=None, overflow=None):
    """Phase A per row: ``(mv, tgt, light)``, whether the row moves, its
    target (``own`` if it stays) and the weight key of its best lanes.
    ``overflow``: the heavy rows' arcs beyond the slab, see
    ``heavy_targets_ref``."""
    validn = nlab >= 0
    staying = nlab == own[:, None]
    if nbud is None:
        fits = (ncw + vw[:, None]) <= W
    else:
        fits = ncw <= (nbud - vw[:, None])
    fits = (fits | staying) & validn
    score = torch.where(fits, ell_conn(nlab, nw), -1)
    best, light, tgt = tie_chain(score, ncw, nlab, salt)
    own_conn = torch.where(staying & validn, nw, 0).sum(1).to(torch.int32)
    mv = (best > own_conn) & (tgt != own) & (tgt < I32_MAX) & (best > 0)
    tgt = torch.where(mv, tgt, own)
    if overflow is not None and overflow[0].shape[0]:
        rows, mv_h, tgt_h, light_h = heavy_targets_ref(
            nlab, nw, ncw, own, vw, W, salt, overflow, nbud)
        mv[rows], tgt[rows], light[rows] = mv_h, tgt_h, light_h
    return mv, tgt, light


def candidates_ref(mv, tgt, own, vw, light, W: int, num_labels: int):
    """Phase B's candidates, the movers whose target would end above
    ``W``, from label-indexed weight tables instead of pairwise masks:
    ``(cand, new_cw)``, ``new_cw`` the target's weight after every move."""
    t_i = tgt.long()
    mvw = torch.where(mv, vw, 0)
    d_in = segment_sum(mvw, t_i, num_labels)
    d_out = segment_sum(mvw, own.long(), num_labels)
    new_cw = light + d_in[t_i] - d_out[t_i]
    return mv & (new_cw > W), new_cw


def lp_move_chunk_ref(nlab, nw, ncw, own, vw, W: int, v0: int, salt: int,
                      num_labels: int, nbud=None, overflow=None):
    """``(moved, tgt)`` (R,) int32 for one ELL chunk.

    nlab/nw/ncw[/nbud] are (R, D) int32 (label -1, weight 0 on padding),
    own/vw (R,) int32; ``nbud is None`` selects the host admission form
    ``ncw + vw <= W``, else the distributed ``ncw <= nbud - vw``. Labels
    lie in [0, num_labels). ``overflow``: ``(rows, ptr, nlab, nw, ncw)``
    of the chunk's heavy rows (``ops.overflow_operands``), and ``nbud``
    sixth in the distributed form, or None."""
    R, _ = nlab.shape
    mv, tgt, light = move_targets_ref(nlab, nw, ncw, own, vw, W, salt, nbud,
                                      overflow)
    cand, new_cw = candidates_ref(mv, tgt, own, vw, light, W, num_labels)
    t_i = tgt.long()
    cvw = torch.where(cand, vw, 0)
    moved_in = segment_sum(cvw, t_i, num_labels)[t_i]
    rows = torch.arange(R, dtype=torch.int32, device=nlab.device)
    rk = hash32(rows + v0, (int(salt) ^ 0x9E3779B9) & 0xFFFFFFFF)
    # candidates by (target, rank, row); the stable sort breaks rank
    # ties by row, the composed path's order
    key = torch.where(cand, (t_i << 31) | rk.long(), 1 << 62)
    order = torch.sort(key, stable=True).indices
    s_key, s_vw = key[order], cvw[order]
    start = torch.ones_like(cand)
    start[1:] = (s_key[1:] >> 31) != (s_key[:-1] >> 31)
    csum = cumsum32(s_vw)
    gid = (cumsum32(start.to(torch.int32)) - 1).long()
    base = (csum - s_vw)[start][gid]
    within = torch.empty_like(csum)
    within[order] = csum - base
    allowed = torch.clamp(W - (new_cw - moved_in), min=0)
    revert = cand & (within > allowed)
    return (mv & ~revert).to(torch.int32), tgt


def lp_move_chunk_stacked_ref(nlab, nw, ncw, own, vw, W, v0, salt,
                              num_labels: int, nbud=None):
    """``(moved, tgt)`` (S, R) int32: ``lp_move_chunk_ref`` of each
    request's chunk ``(nlab[s], ...)`` with ``(W[s], v0[s], salt[s])``
    (``salt`` as int32 bit patterns), stacked."""
    Ws, v0s, salts = (torch.as_tensor(x).tolist() for x in (W, v0, salt))
    outs = [lp_move_chunk_ref(nlab[s], nw[s], ncw[s], own[s], vw[s], Ws[s],
                              v0s[s], salts[s] & 0xFFFFFFFF, num_labels,
                              nbud=None if nbud is None else nbud[s])
            for s in range(nlab.shape[0])]
    return (torch.stack([m for m, _ in outs]),
            torch.stack([t for _, t in outs]))
