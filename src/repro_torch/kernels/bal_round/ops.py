"""Host-side ELL construction + round of the fused balancer.

``core.balance.rebalance`` feeds the composed round a single-chunk arc
slab, sorted per round. The fused round takes the graph in ELL form once,
one row per label-table slot ``0 .. n_pad`` and D warp-padded neighbor
lanes; the per-round work is the K-entry fallback table, the two kernels
(``bal_scores`` reads the ELL ids and the block tables itself) and the
pool sort: no (rows, D) tensor is built per round. The sentinel and
padded rows carry no arcs and are masked (rows ``>= n``) exactly as the
composed path masks them, so (labels, block_w) trajectories are
bit-identical. The slab's width is capped as the LP move kernel's is
(``lp_move.ops.slab_width``); a hub's arcs beyond it go to an
``Overflow``, which ``bal_scores`` takes by its heavy-row path.

The distributed balancer (``dist/dist_balance.py``) scores one PE's
shard: its lanes index the PE's label table ``tab`` = [local labels,
ghost labels, sentinel k], its own blocks are the local labels, and its
valid rows are the PE's real vertices, a prefix of its rows. The kernel
serves that form as it is: the dist ELL (``build_balance_ell_dist``) has
a row for every table entry (rows past the local ones carry no arcs), so
``tab`` is the kernel's label table, each local row's own block is its
table entry, and validity is ``r < n_valid``. Only rows that never move
(the sentinel and the ghost rows) read another own block than the
reference's, and their targets are never applied.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.lp import I32_MAX, segment_min
from .. import dispatch
from ..lp_move import ops as move_ops
from .bal_round import bal_scores, greedy_pick


def build_balance_ell(g, n_pad: int, device=None):
    """(n_pad + 1, D) neighbor-id / weight ELL over the label-table row
    space, -1 / 0 padding, and the heavy rows' ``Overflow`` (or None):
    ``(idx, w, overflow)``. Raises ``dispatch.EllTooLarge`` before it
    allocates when the build would not fit the host, or the card
    (``device``, CUDA)."""
    deg = np.diff(g.indptr)
    rows = n_pad + 1
    D = move_ops.slab_width(deg, rows)
    slab, over, temp = move_ops.split_bytes(deg, rows, D, 1)
    # on the card: the slabs, the overflow and the heavy rows' label
    # tables (16 bytes a lane of theirs)
    dispatch.check_ell_bytes("build_balance_ell", (rows, D),
                             slab + over + temp,
                             slab + over + 16 * int(deg[deg > D].sum()),
                             device)
    idx = np.full((rows, D), -1, dtype=np.int32)
    w = np.zeros((rows, D), dtype=np.int32)
    overflow = move_ops.ell_rows(np.asarray(g.indptr), g.adjncy,
                                 g.eweights, 0, g.n, idx, w)
    return idx, w, overflow


def build_balance_ell_dist(shards, p: int, device=None):
    """PE ``p``'s ELL over its label-table rows (locals, ghosts,
    sentinel): ``(idx, w, overflow)``, lanes holding indices into the
    table, the ghost and sentinel rows empty; width capped and hub arcs in
    the ``Overflow`` as in ``build_balance_ell``. Sentinel arcs (src ==
    n_loc) are dropped: arc-less rows never move."""
    indptr, adj, aw = move_ops.local_csr(shards, p)
    rows = shards.table_size
    deg = np.zeros(rows, dtype=np.int64)
    deg[:shards.n_loc] = np.diff(indptr)
    D = move_ops.slab_width(deg, rows)
    slab, over, temp = move_ops.split_bytes(deg, rows, D, 1)
    dispatch.check_ell_bytes("build_balance_ell_dist", (rows, D),
                             slab + over + temp,
                             slab + over + 16 * int(deg[deg > D].sum()),
                             device)
    idx = np.full((rows, D), -1, dtype=np.int32)
    w = np.zeros((rows, D), dtype=np.int32)
    overflow = move_ops.ell_rows(indptr, adj, aw, 0, shards.n_loc, idx, w)
    return idx, w, overflow


def fallback_table(block_w, parent, restricted: bool):
    """Each block's lightest-block fallback target, (K,) int32: the
    lightest block overall, or (restricted) the lightest sibling within the
    block's parent group; ties to the smaller block id."""
    k = block_w.shape[0]
    ids = torch.arange(k, dtype=torch.int32, device=block_w.device)
    if restricted:
        p = parent.long()
        grp_min = segment_min(block_w, p, k)
        bid = torch.where(block_w == grp_min[p], ids, I32_MAX)
        return segment_min(bid, p, k)[p]
    first_min = torch.where(block_w == block_w.min(), ids, I32_MAX).min()
    return first_min.expand(k).contiguous()


def fused_round_scores(labels, bw, l_max, parent, ell_idx, ell_w, vw_pad,
                       n: int, salt: int, *, restricted: bool,
                       overflow=None):
    """``bal_scores`` on the ELL form (and its overflow, as tensors) and
    the block tables; its fallback targets composed with K-sized ops
    exactly as ``core.balance.balance_gains`` composes them."""
    fb = fallback_table(bw, parent, restricted)
    return bal_scores(ell_idx, ell_w, labels, vw_pad, bw, l_max, fb, n, salt,
                      parent=parent if restricted else None,
                      overflow=overflow)


def fused_round_scores_dist(tab, lab_src, bw, l_max, ell_idx, ell_w,
                            vw_pad, vld: int, salt: int, overflow=None):
    """The distributed round's scores, the reference's ``(tab, lab_src,
    bw, l_max, ..., vld)`` form: ``bal_scores`` over the PE's table-row
    ELL (``build_balance_ell_dist``), ``(rel, tgt)`` over the (n_loc + 1,)
    rows of ``lab_src`` / ``vw_pad``. ``vld`` is the number of valid rows,
    a prefix (the reference's ``gid < n``); unrestricted only. Counted as
    ``bal_scores_dist``."""
    num = lab_src.shape[0]
    vw_tab = torch.cat([vw_pad, vw_pad.new_zeros(tab.shape[0] - num)])
    fb = fallback_table(bw, None, False)
    rel, tgt = bal_scores(ell_idx, ell_w, tab, vw_tab, bw, l_max, fb, vld,
                          salt, overflow=overflow, dist=True)
    return rel[:num], tgt[:num]


def balance_round_fused(labels, block_w, l_max, parent, ell_idx, ell_w,
                        vweights, n: int, salt: int, *, top_m: int,
                        restricted: bool = False, overflow=None):
    """Fused twin of ``core.balance.balance_round``: same pool ranking,
    same accept rule, bit-identical (labels, block_w) trajectory; rows
    ``>= n`` (padding and the sentinel) never move. Updates ``labels`` in
    place and returns it."""
    rel, tgt = fused_round_scores(labels, block_w, l_max, parent, ell_idx,
                                  ell_w, vweights, n, salt,
                                  restricted=restricted, overflow=overflow)
    # lax.top_k order: descending, ties to the lower index (torch.topk
    # breaks ties differently; a stable descending sort does not)
    vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
    t_v, l_v = tgt[vidx], labels[vidx]
    accept, block_w = greedy_pick(rel[vidx], t_v, l_v, vweights[vidx],
                                  block_w, l_max)
    labels[vidx] = torch.where(accept, t_v, l_v)
    return labels, block_w, bool((block_w > l_max).any())
