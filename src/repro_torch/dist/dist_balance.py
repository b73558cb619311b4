"""Distributed greedy balancing (paper §4, Balancing) — port of
``repro.dist.dist_balance`` onto ``torch.distributed``.

Per round each PE scores its own shard (``core.balance.balance_gains``
over its sorted arcs, or the ``bal_scores`` kernel over its table-row ELL
when fused) and pools its ``top_m`` candidates; the pools are
all-gathered (direct or grid), ranked by (descending gain, vertex id) and
applied by the greedy walk (``greedy_select`` / the ``greedy_pick``
kernel) redundantly on every PE, so all PEs agree on the accepted moves
without a root. Block weight tables come in the same two layouts as
``dist_lp``: replicated (every PE keeps the dense (k+1,) table) or
owner-sharded (each PE keeps its slice and all-gathers the dense view at
the top of each round). Both produce bit-identical labels; at P=1 the
balancer equals ``core.balance.rebalance``.

``dist_enforce_cluster_weights`` is the coarsening-side half: the exact
eject-to-singleton sweep of ``core.coarsening.enforce_cluster_weights``,
run owner-side. Member records travel to the cluster's owner through one
all-to-all, the owner applies the keep-heaviest-first-prefix rule over
the members it alone sees in full, and the eject flags ride the reverse
all-to-all back. Ejected vertices move to cluster id ``n + vertex_gid``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.balance import balance_gains, greedy_select
from ..core.lp import I32_MAX, cumsum32, segment_min, sort2
from ..graphs.distribute import GraphShards
from ..kernels import dispatch
from ..kernels.bal_round import ops as bal_ops
from ..kernels.bal_round.bal_round import greedy_pick
from .collectives import PeGroup, all_gather_1d, all_to_all, halo_exchange
from .dist_lp import (_check_int32_weights, _check_weights_mode,
                      gather_global, on_dev, owner_table_width, resolve_pe)

# bytes per pooled candidate record: 4 int32 fields + 1 f32 gain
_POOL_RECORD_BYTES = 20


def _desc_order(vals: torch.Tensor) -> torch.Tensor:
    """``lax.top_k`` order: descending, ties to the lower index."""
    return torch.sort(vals, descending=True, stable=True).indices


# ---------------------------------------------------------------------------
# distributed balancing rounds
# ---------------------------------------------------------------------------

def dist_rebalance(shards: GraphShards,
                   part: np.ndarray,
                   l_max_vec: np.ndarray,
                   top_m: int = 128,
                   max_rounds: int = 200,
                   seed: int = 0,
                   use_grid: bool = True,
                   pe: PeGroup = None,
                   weights: str = "replicated",
                   kernel: str = "auto",
                   stats: Optional[Dict] = None) -> np.ndarray:
    """Distributed exact balancer: rounds of pooled greedy moves until
    every block fits its budget. Returns the (n,) assignment on every rank.

    Bit-identical to ``core.balance.rebalance(g, part, l_max_vec)`` at
    P=1; at P>1 each PE contributes its own ``top_m`` candidates per
    round. ``weights`` picks the block-table layout and ``kernel`` the
    round's implementation (``bal_scores`` / ``greedy_pick``); every
    combination gives the same labels. ``stats``, when given, receives
    ``rounds`` / ``pool_bytes`` / ``halo_bytes`` / ``time_s``."""
    P, n = shards.P, shards.n
    owner = _check_weights_mode(weights)
    k = int(l_max_vec.shape[0])
    part = np.asarray(part, dtype=np.int64)
    l_max_vec = np.asarray(l_max_vec, dtype=np.int64)
    t_start = time.perf_counter()

    valid = shards.local_gid < n
    vw_glob = np.zeros(n, dtype=np.int64)
    vw_glob[shards.local_gid[valid]] = shards.vweights[valid]
    bw0 = np.zeros(k, dtype=np.int64)
    np.add.at(bw0, part, vw_glob)
    if not bool(np.any(bw0 > l_max_vec)):   # already feasible: no device work
        if stats is not None:
            stats.update(rounds=0, pool_bytes=0, halo_bytes=0,
                         time_s=time.perf_counter() - t_start)
        return part.copy()

    _check_int32_weights(shards)
    pe = resolve_pe(pe, P)
    dev, p = pe.device, pe.rank
    n_loc, n_ghost = shards.n_loc, shards.n_ghost
    kk = k + 1
    S_k = owner_table_width(kk, P)
    L = P * S_k if owner else kk
    # sentinel / pad blocks: maximal weight and budget — never overloaded,
    # never a fitting target, never the argmin fallback
    bw_dense = np.full(L, I32_MAX, dtype=np.int32)
    bw_dense[:k] = bw0
    lmax_dense = np.full(L, I32_MAX, dtype=np.int32)
    lmax_dense[:k] = np.minimum(l_max_vec, int(I32_MAX))
    bw_state = on_dev(bw_dense[p * S_k:(p + 1) * S_k] if owner
                      else bw_dense, dev)
    l_max = on_dev(lmax_dense, dev)

    top_m_loc = min(top_m, n_loc + 1)
    part_pad = np.concatenate([part, [k]])   # sentinel gid n -> block k
    lab_loc = on_dev(part_pad[np.minimum(shards.local_gid[p], n)]
                     .astype(np.int32), dev)
    lab_ghost = on_dev(part_pad[np.minimum(shards.ghost_gid[p], n)]
                       .astype(np.int32), dev)
    vw_loc = on_dev(shards.vweights[p], dev)
    lgid = on_dev(shards.local_gid[p], dev)
    send_idx = on_dev(shards.send_idx[p], dev)
    recv_slot = on_dev(shards.recv_slot[p], dev)
    vw_pad = torch.cat([vw_loc, vw_loc.new_zeros(1)])
    gid_pad = torch.cat([lgid, torch.full((1,), n, dtype=torch.int32,
                                          device=dev)])
    vld = gid_pad < n
    n_valid = int(valid[p].sum())
    sentinel = torch.full((1,), k, dtype=torch.int32, device=dev)
    v0, v1 = int(shards.offsets[p]), int(shards.offsets[p + 1])

    fused = dispatch.resolve_kernel_mode(kernel, dev) == "fused"
    if fused:
        idx, ew, ov = bal_ops.build_balance_ell_dist(shards, p, device=dev)
        ell = (on_dev(idx, dev), on_dev(ew, dev),
               None if ov is None else tuple(on_dev(x, dev) for x in ov))
    else:
        src, dst, w = (on_dev(x[p], dev) for x in (
            shards.arc_src, shards.arc_dst_idx, shards.arc_w))

    rounds = 0
    for r in range(max_rounds):
        salt = (seed * 7919 + r) % (2**32)
        # dense block-weight view for this round (owner mode: request)
        bw = all_gather_1d(bw_state, pe, use_grid=use_grid) if owner \
            else bw_state
        tab = torch.cat([lab_loc, lab_ghost, sentinel])
        lab_src_tab = torch.cat([lab_loc, sentinel])
        if fused:
            rel, tgt = bal_ops.fused_round_scores_dist(
                tab, lab_src_tab, bw, l_max, ell[0], ell[1], vw_pad,
                n_valid, salt, overflow=ell[2])
        else:
            lab_dst = tab[dst.long()]
            order = sort2(src, lab_dst)
            rel, tgt = balance_gains(lab_src_tab, src[order],
                                     lab_dst[order], w[order], bw, l_max,
                                     None, vw_pad, salt, n_loc, valid=vld,
                                     restricted=False)

        # local top-m pool -> gathered (P*top_m,) pool on every PE
        vidx = _desc_order(rel)[:top_m_loc]
        vals = rel[vidx]
        pool = torch.stack([gid_pad[vidx], tgt[vidx], lab_src_tab[vidx],
                            vw_pad[vidx]], dim=1)          # (top_m, 4)
        pool = all_gather_1d(pool, pe, use_grid=use_grid)
        pvals = all_gather_1d(vals, pe, use_grid=use_grid)

        # deterministic ranking: descending gain, ties by vertex id
        o = torch.sort(pool[:, 0], stable=True).indices
        o = o[_desc_order(pvals[o])]
        o_val, o_gid, o_tgt, o_blk, o_w = (pvals[o], pool[o, 0], pool[o, 1],
                                           pool[o, 2], pool[o, 3])
        pick = greedy_pick if fused else greedy_select
        accept, bw = pick(o_val, o_tgt, o_blk, o_w, bw, l_max)

        # apply accepted moves to the locally-owned vertices
        mine = accept & (o_gid >= v0) & (o_gid < v1)
        lab_loc[(o_gid[mine] - v0).long()] = o_tgt[mine]
        lab_ghost = halo_exchange(lab_loc, send_idx, recv_slot, n_ghost, pe,
                                  use_grid=use_grid)

        overloaded = bool((bw[:k] > l_max[:k]).any())
        # owner mode: keep only this PE's authoritative slice
        bw_state = bw[p * S_k:(p + 1) * S_k] if owner else bw
        rounds = r + 1
        if not overloaded:
            break

    out = gather_global(lab_loc, shards, pe)
    if stats is not None:
        stats.update(
            rounds=rounds,
            # per-PE gathered pool volume + ghost refresh, per run
            pool_bytes=rounds * P * top_m_loc * _POOL_RECORD_BYTES,
            halo_bytes=rounds * shards.comm_bytes_per_halo(),
            time_s=time.perf_counter() - t_start)
    return out


# ---------------------------------------------------------------------------
# sharded exact cluster-weight enforcement (coarsening-side balancing)
# ---------------------------------------------------------------------------

def dist_enforce_cluster_weights(shards: GraphShards,
                                 labels: np.ndarray,
                                 max_weight: int,
                                 use_grid: bool = True,
                                 pe: PeGroup = None,
                                 stats: Optional[Dict] = None
                                 ) -> np.ndarray:
    """Sharded exact max-cluster-weight enforcement, on every rank.

    Ejects the identical vertex set as the host sweep
    (``core.coarsening.enforce_cluster_weights``) — owners apply the same
    deterministic (cluster, -weight, id) prefix rule over all members of
    their clusters — but assigns ejected vertices the fresh singleton id
    ``n + vertex_gid``. ``labels`` must be LP cluster labels (values are
    vertex ids < n)."""
    P, n = shards.P, shards.n
    if n >= 2**30:
        raise ValueError(
            f"dist_enforce_cluster_weights: n = {n} >= 2^30 would "
            "overflow the int32 fresh-singleton id space (n + gid)")
    labels = np.asarray(labels, dtype=np.int64)
    if labels.shape != (n,) or (n and labels.max() >= n):
        raise ValueError(
            "dist_enforce_cluster_weights expects (n,) LP labels with "
            f"values < n, got shape {labels.shape}")
    _check_int32_weights(shards)   # the owner-side cumsum is int32
    pe = resolve_pe(pe, P)
    dev, p = pe.device, pe.rank
    n_loc = shards.n_loc
    t0 = time.perf_counter()
    W = max(1, min(int(max_weight), int(I32_MAX)))
    lab_pad = np.concatenate([labels, [n]])
    lab_loc = on_dev(lab_pad[np.minimum(shards.local_gid[p], n)]
                     .astype(np.int32), dev)
    vw_loc = on_dev(shards.vweights[p], dev)
    lgid = on_dev(shards.local_gid[p], dev)

    S_w = owner_table_width(n + 1, P)   # cluster id c is owned by c // S_w
    R = P * n_loc                       # owner-side member rows
    iota = torch.arange(n_loc, dtype=torch.int32, device=dev)
    valid = lgid < n
    dest = torch.where(valid, torch.div(lab_loc, S_w, rounding_mode="floor"),
                       P).to(torch.int32)          # P == drop

    # pack member records into per-owner segments of the send slab
    o = sort2(dest, lgid)
    o_dest, o_lab, o_vw, o_gid, o_idx = (dest[o], lab_loc[o], vw_loc[o],
                                         lgid[o], iota[o])
    runs = torch.ones_like(o_dest, dtype=torch.bool)
    runs[1:] = o_dest[1:] != o_dest[:-1]
    rid = (cumsum32(runs.to(torch.int32)) - 1).long()
    run0 = segment_min(torch.where(runs, iota, I32_MAX), rid, n_loc)
    pos = iota - run0[rid]
    fidx = torch.where(o_dest < P, o_dest * n_loc + pos, R).long()
    slab = torch.stack([torch.full((R + 1,), n, dtype=torch.int32,
                                   device=dev),
                        torch.zeros(R + 1, dtype=torch.int32, device=dev),
                        torch.full((R + 1,), n, dtype=torch.int32,
                                   device=dev)], dim=-1)
    slab[fidx] = torch.stack([o_lab, o_vw, o_gid], dim=-1)
    slab = slab[:R].reshape(P, n_loc, 3)          # row R: the dropped

    # owners see every member of their clusters
    recv = all_to_all(slab, pe, use_grid=use_grid)
    r_lab = recv[:, :, 0].reshape(R)
    r_vw = recv[:, :, 1].reshape(R)
    r_gid = recv[:, :, 2].reshape(R)

    # shared decision rule: sort by (cluster, -weight, id), eject when
    # the cumulative kept weight exceeds W — never the first member
    riota = torch.arange(R, dtype=torch.int32, device=dev)
    s = torch.sort(r_gid, stable=True).indices
    s = s[torch.sort(-r_vw[s], stable=True).indices]
    s = s[torch.sort(r_lab[s], stable=True).indices]
    s_lab, s_j = r_lab[s], riota[s]
    s_vw = torch.where(s_lab < n, r_vw[s], 0)
    starts = torch.ones_like(s_lab, dtype=torch.bool)
    starts[1:] = s_lab[1:] != s_lab[:-1]
    grp = (cumsum32(starts.to(torch.int32)) - 1).long()
    csum = cumsum32(s_vw)
    base = segment_min(torch.where(starts, csum - s_vw, I32_MAX), grp, R)
    within = csum - base[grp]
    eject = (s_lab < n) & (within > W) & ~starts

    # eject flags ride the reverse exchange back to the member's PE
    flags = torch.zeros(R, dtype=torch.bool, device=dev)
    flags[s_j.long()] = eject
    back = all_to_all(flags.reshape(P, n_loc), pe,
                      use_grid=use_grid).reshape(R)
    fl = torch.where(o_dest < P, back[torch.clamp(fidx, max=R - 1)], False)
    ej_loc = torch.zeros(n_loc, dtype=torch.bool, device=dev)
    ej_loc[o_idx.long()] = fl

    # fresh singleton id n + gid: unused, since LP labels are ids < n
    lab_out = torch.where(ej_loc & valid, n + lgid, lab_loc)
    out = gather_global(lab_out, shards, pe)
    if stats is not None:
        ejected = all_gather_1d(ej_loc.sum().to(torch.int32).reshape(1), pe)
        stats.update(ejected=int(ejected.sum()),
                     slab_bytes_per_pe=int(P * n_loc * 12),
                     time_s=time.perf_counter() - t0)
    return out
