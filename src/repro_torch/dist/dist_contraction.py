"""Distributed cluster contraction (paper §5, Graph Contraction) — port of
``repro.dist.dist_contraction`` onto ``torch.distributed``.

Each level stays sharded:

  1. **cluster → PE ownership** — clusters are assigned to PEs by a
     multiplicative hash of the cluster id and renumbered so each owner
     holds a contiguous coarse id range (host code, identical on every
     rank).
  2. **local pre-contraction** — each rank maps its own arc slab through
     the cluster mapping and deduplicates it (``core.contraction.
     dedup_arcs``: numpy, or the ``seg_merge`` kernel when fused), so the
     exchange ships deduplicated coarse arcs. The per-destination segment
     counts are all-gathered, so every rank knows the (P, P) table the
     reference's host loop computes.
  3. **segmented all-to-all edge exchange** — pre-contracted arcs travel
     to the owner of their coarse tail (``collectives.exchange_segments``,
     direct or grid), and the owner merges duplicates: a sort + segment
     sum, or the ``seg_merge`` kernel (bit-identical).
  4. **owner-side assembly** — the owners' merged arcs are all-gathered
     and every rank assembles the next level's ``GraphShards`` and the
     host view, as the reference's host does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from ..core.contraction import dedup_arcs
from ..core.lp import I32_MAX, cumsum32, segment_sum, sort2
from ..graphs.distribute import GraphShards, assemble_shards
from ..graphs.format import Graph, from_coo
from ..kernels import dispatch
from ..kernels.seg_merge.seg_merge import seg_merge
from .collectives import PeGroup, all_gather_1d, exchange_segments
from .dist_lp import _check_int32_weights, on_dev, resolve_pe


@dataclasses.dataclass(frozen=True)
class DistContraction:
    """Result of one sharded contraction level."""
    shards: GraphShards      # coarse graph, contiguous per-owner ranges
    graph: Graph             # host view (base case / exact balancer only)
    mapping: np.ndarray      # (n_fine,) int64 fine gid -> coarse gid
    stats: Dict              # exchange payload / timing for benchmarks


def cluster_owners(cluster_ids: np.ndarray, P: int) -> np.ndarray:
    """Hash-based cluster → PE assignment (paper §5): spreads ownership
    independently of the id distribution the clustering produced."""
    h = (cluster_ids.astype(np.uint64) * np.uint64(2654435761)) \
        & np.uint64(0xFFFFFFFF)
    h ^= np.uint64(0x9E3779B9)
    h ^= h >> np.uint64(15)
    return (h % np.uint64(max(1, P))).astype(np.int64)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def _merge(src, dst, w, fused: bool, max_id: int):
    """Owner-side duplicate merge of the received records: ``(s_src,
    s_dst, tot, first)``, sorted by (src, dst), each record carrying its
    run's total, ``first`` its run start."""
    if fused:
        s_src, s_dst, tot, first32 = seg_merge(src, dst, w, max_id=max_id)
        return s_src, s_dst, tot, first32 != 0
    order = sort2(src, dst)
    s_src, s_dst, s_w = src[order], dst[order], w[order]
    first = torch.ones_like(s_src, dtype=torch.bool)
    first[1:] = (s_src[1:] != s_src[:-1]) | (s_dst[1:] != s_dst[:-1])
    gid = (cumsum32(first.to(torch.int32)) - 1).long()
    tot = segment_sum(s_w, gid, s_w.shape[0])
    return s_src, s_dst, tot[gid], first


def _global_vweights(shards: GraphShards) -> np.ndarray:
    vw = np.zeros(shards.n, dtype=np.int64)
    valid = shards.local_gid < shards.n
    vw[shards.local_gid[valid]] = shards.vweights[valid]
    return vw


def dist_contract(shards: GraphShards,
                  labels: np.ndarray,
                  use_grid: bool = False,
                  pe: PeGroup = None,
                  kernel: str = "auto") -> DistContraction:
    """Contract clustering ``labels`` over graph shards without gathering
    the fine graph. Returns, on every rank, the coarse graph both as shards
    (fed straight into the next level's distributed clustering) and as a
    host view (consumed only by the host-side base case / exact
    balancer), plus the fine→coarse mapping used for uncoarsening."""
    P, n = shards.P, shards.n
    labels = np.asarray(labels, dtype=np.int64)
    if labels.shape != (n,):
        raise ValueError(f"dist_contract: labels of shape {labels.shape} "
                         f"for n={n}")
    _check_int32_weights(shards)   # the exchange slab is int32
    pe = resolve_pe(pe, P)
    dev, p = pe.device, pe.rank

    # ---- ownership + owner-contiguous renumbering ----------------------
    uniq, inv = np.unique(labels, return_inverse=True)
    nc = int(uniq.size)
    owner = cluster_owners(uniq, P)
    order = np.lexsort((uniq, owner))       # group clusters by owner PE
    rank = np.empty(nc, dtype=np.int64)
    rank[order] = np.arange(nc)
    mapping = rank[inv]
    coff = np.concatenate(
        [[0], np.cumsum(np.bincount(owner, minlength=P))]).astype(np.int64)

    # coarse vertex weights, accumulated into owner slices
    cvw = np.zeros(nc, dtype=np.int64)
    np.add.at(cvw, mapping, _global_vweights(shards))

    # ---- this PE's local pre-contraction ------------------------------
    kmode = dispatch.resolve_kernel_mode(kernel, dev)
    t0 = time.perf_counter()
    valid = shards.arc_src[p] < shards.n_loc
    src_g = shards.local_gid[p][shards.arc_src[p][valid]]
    tab_g = np.concatenate([shards.local_gid[p], shards.ghost_gid[p]])
    dst_g = tab_g[shards.arc_dst_idx[p][valid]]
    cs, cd, cw = dedup_arcs(mapping[src_g], mapping[dst_g],
                            shards.arc_w[p][valid].astype(np.int64),
                            kernel=kmode, device=dev)
    # dedup_arcs sorts by coarse tail; owner ranges are contiguous in
    # coarse-id space, so destination segments are already contiguous
    dest = np.searchsorted(coff, cs, side="right") - 1
    mine = np.bincount(dest, minlength=P).astype(np.int32)
    seg_counts = all_gather_1d(on_dev(mine, dev), pe).reshape(P, P)
    seg_counts = seg_counts.cpu().numpy()
    pre_s = time.perf_counter() - t0

    # ---- segmented all-to-all + owner-side merge -----------------------
    S_e = _next_pow2(max(1, int(seg_counts.max())))
    slab = np.zeros((P, S_e, 3), dtype=np.int32)
    ends = np.cumsum(seg_counts[p])
    starts = ends - seg_counts[p]
    for q in range(P):
        s0, s1 = int(starts[q]), int(ends[q])
        slab[q, :s1 - s0, 0] = cs[s0:s1]
        slab[q, :s1 - s0, 1] = cd[s0:s1]
        slab[q, :s1 - s0, 2] = cw[s0:s1]
    t0 = time.perf_counter()
    L = P * S_e
    recv, rcounts = exchange_segments(on_dev(slab, dev),
                                      on_dev(seg_counts[p], dev), pe,
                                      use_grid=use_grid)
    keep = torch.arange(S_e, dtype=torch.int32, device=dev)[None, :] < \
        rcounts[:, None]                                      # (P, S_e)
    src = torch.where(keep, recv[:, :, 0], I32_MAX).reshape(L)
    dst = torch.where(keep, recv[:, :, 1], I32_MAX).reshape(L)
    w = torch.where(keep, recv[:, :, 2], 0).reshape(L)
    merged = _merge(src, dst, w, kmode == "fused", max(0, nc - 1))
    s_src, s_dst, wsum, first = (
        all_gather_1d(x, pe).reshape(P, L).cpu().numpy() for x in merged)
    exchange_s = time.perf_counter() - t0

    # ---- owner-side coarse shards + host view --------------------------
    arc_parts = []
    for q in range(P):
        take = (s_src[q] < int(I32_MAX)) & first[q]
        arc_parts.append((s_src[q][take].astype(np.int64),
                          s_dst[q][take].astype(np.int64),
                          wsum[q][take].astype(np.int64)))
    vw_parts = [cvw[coff[q]:coff[q + 1]] for q in range(P)]
    coarse_shards = assemble_shards(nc, coff, arc_parts, vw_parts)
    # arc parts are sorted by coarse tail within each PE and owner ranges
    # ascend with p, so the concatenation is already in CSR order
    graph = from_coo(nc,
                     np.concatenate([a[0] for a in arc_parts]),
                     np.concatenate([a[1] for a in arc_parts]),
                     eweights=np.concatenate([a[2] for a in arc_parts]),
                     vweights=cvw, symmetrize=False, dedup=False)
    stats = {
        "nc": nc,
        "payload_bytes": int(seg_counts.astype(np.int64).sum()) * 12,
        "slab_bytes_per_pe": int(P * S_e * 3 * 4),
        "precontract_s": round(pre_s, 6),
        "exchange_s": round(exchange_s, 6),
    }
    return DistContraction(shards=coarse_shards, graph=graph,
                           mapping=mapping, stats=stats)
