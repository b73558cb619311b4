"""Plain-PyTorch version of the ``lp_move`` CUDA kernel.

It follows the kernel's reformulation, not the composed sort path:
phase A per ELL row (label-equality connectivity, admission, the 4-stage
tie chain), phase B over the chunk with label-indexed weight tables and
one sort of the candidates by (target, rank, row), instead of the TPU
kernel's R x R pairwise masks. The wrapper runs it for CPU tensors, the
tests hold it bit-identical to the JAX package's ``lp_move_chunk_ref``,
and the chip check holds the kernel to it. Nothing on the CUDA path
calls it.
"""
from __future__ import annotations

import torch

from ...core.lp import I32_MAX, cumsum32, hash32, segment_sum

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


def move_targets_ref(nlab, nw, ncw, own, vw, W: int, salt: int,
                     nbud=None):
    """Phase A per row: ``(mv, tgt, light)``, whether the row moves, its
    target (``own`` if it stays) and the weight key of its best lanes."""
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
    return mv, torch.where(mv, tgt, own), light


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
                      num_labels: int, nbud=None):
    """``(moved, tgt)`` (R,) int32 for one ELL chunk.

    nlab/nw/ncw[/nbud] are (R, D) int32 (label -1, weight 0 on padding),
    own/vw (R,) int32; ``nbud is None`` selects the host admission form
    ``ncw + vw <= W``, else the distributed ``ncw <= nbud - vw``. Labels
    lie in [0, num_labels)."""
    R, _ = nlab.shape
    mv, tgt, light = move_targets_ref(nlab, nw, ncw, own, vw, W, salt, nbud)
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
