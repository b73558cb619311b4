"""Plain-PyTorch version of the ``lp_gain`` CUDA kernel.

Per ELL row: the best admissible connection weight, its label (the
smallest among the maximisers) and the connection to the own label; the
JAX package's ``lp_gain_ell_ref`` op for op, except that the
label-equality connectivity is summed per (row, label) group in lane
order, as the kernel sums it, instead of over the (N, D, D) equality
cube. Weight sums of integer-valued f32 below 2^24 are exact in any
order, so on the graph path the two agree bit for bit. The wrapper runs
it for CPU tensors; the chip check holds the kernel to it.
"""
from __future__ import annotations

import torch

BIG = 2**30     # the reference's "no maximiser" label


def ell_conn_f32(lab: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conn[r, j] = sum_i w[r, i] * [lab[r, i] == lab[r, j]]`` (f32),
    summed per (row, label) group; labels are >= -1."""
    N, D = lab.shape
    rows = torch.arange(N, dtype=torch.int64, device=lab.device)[:, None]
    key = (rows << 32) | (lab.to(torch.int64) + 1)
    _, grp = torch.unique(key, return_inverse=True)
    sums = torch.zeros(N * D, dtype=torch.float32, device=lab.device)
    sums.index_add_(0, grp.reshape(-1), w.reshape(-1))
    return sums[grp]


def lp_gain_ell_ref(lab, w, tgt_w, own_lab, vw, budget):
    """``(best, target, own_conn)``, each (N, 1): f32, int32, f32.
    lab (N, D) int32 (-1 on padding), w / tgt_w (N, D) f32, own_lab (N, 1)
    int32, vw (N, 1) f32, budget (1, 1) f32."""
    conn = ell_conn_f32(lab, w)
    valid = lab >= 0
    staying = lab == own_lab
    fits = (tgt_w + vw <= budget[0, 0]) & ~staying & valid
    score = torch.where(fits, conn, -1.0)
    best = score.max(1, keepdim=True).values
    is_best = (score == best) & fits
    target = torch.where(is_best, lab, BIG).min(1, keepdim=True).values
    target = torch.where(best >= 0, target, -1).to(torch.int32)
    own_conn = torch.where(staying & valid, w, 0.0).sum(1, keepdim=True)
    return best, target, own_conn
