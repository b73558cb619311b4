"""Distributed size-constrained label propagation (paper §4) — port of
``repro.dist.dist_lp`` onto ``torch.distributed``.

The reference's ``shard_map`` program becomes SPMD over a process group:
every rank runs the same host code, holds only its own PE's rows of the
stacked ``GraphShards`` arrays on its device, and runs the per-PE body of
the reference op for op; the ``lax.scan`` over chunks is a loop whose
collectives run in the same order on every rank. Labels are *global* ids,
and ghost labels are refreshed through the static halo schedule after
every chunk. Every function returns what the reference returns, on every
rank: the final labels come back through an all-gather.

Cluster/block weight tables come in two layouts, selected by the
``weights`` argument:

  * ``"replicated"`` — every PE carries the full (n+1,)/(k+1,) table,
    synchronized by an all-reduce after each chunk.
  * ``"owner"`` — each PE persistently holds only its ~(n/P,) shard of
    the table (uniform block distribution of the label space). Movers
    request current weights via ``all_gather_1d`` at the top of each
    chunk and commit their deltas via ``psum_scatter_1d``; the overweight
    check runs on the owner's authoritative shard before the flags are
    gathered back for the bounce.

Both layouts apply identical integer arithmetic in the same order, so
they produce bit-identical labels. Intra-PE races within a chunk use the
exact hash-ordered revert of ``core.lp._cluster_chunk``; cross-PE races
are detected after the commit and overweight clusters *bounce* this
chunk's incoming moves back. Exact enforcement happens before contraction.

``kernel="fused"`` runs the chunk move through the ``lp_move`` kernel in
its distributed admission form (``ncw <= nbud - vw``, counted as
``lp_move_dist``); on a CPU tensor the wrapper runs its plain version.
There is no fallback: an ELL build past its byte limit raises
``dispatch.EllTooLarge``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.lp import (I32_MAX, _argmax_target, _group_conns,
                       _own_connection, cumsum32, hash32, segment_min,
                       segment_sum, sort2)
from ..graphs.distribute import GraphShards, chunk_local_arcs
from ..kernels import dispatch
from ..kernels.lp_move import ops as move_ops
from ..kernels.lp_move.lp_move import lp_move_chunk
from .collectives import (PeGroup, all_gather_1d, halo_exchange, psum,
                          psum_scatter_1d, world_group)

_BIG = 2**30

WEIGHT_MODES = ("replicated", "owner")


def _check_weights_mode(weights: str) -> bool:
    if weights not in WEIGHT_MODES:
        raise ValueError(f"unknown weights mode {weights!r}; expected one "
                         f"of {WEIGHT_MODES}")
    return weights == "owner"


def owner_table_width(num_labels: int, P: int) -> int:
    """Per-PE owner-shard width: uniform block distribution of the label
    space, padded so P shards tile the dense table exactly."""
    return -(-num_labels // P)


def _check_int32_weights(shards: GraphShards) -> None:
    """The int32 weight tables (all-reduced) must never wrap."""
    tot_v = int(shards.vweights.astype(np.int64).sum())
    tot_e = int(shards.arc_w.astype(np.int64).sum())
    if tot_v >= 2**31 or tot_e >= 2**31:
        raise ValueError(
            f"dist_lp: total vertex/edge weight ({tot_v}/{tot_e}) must "
            "be < 2^31 for the int32 device path")


def make_mesh_1d(P: int, device=None):
    """A 1-D mesh of P PEs (``api.runtime.PeMesh``), one rank process
    each: the first P cards, or P gloo ranks for ``device="cpu"``. The
    engine's functions run on it through ``PeMesh.call``."""
    from ..api.runtime import PeMesh, mesh_devices
    return PeMesh(mesh_devices(P, device))


def resolve_pe(pe, P: int) -> PeGroup:
    """Accept a caller's ``PeGroup`` or take the initialised default
    group's; either way it must have P ranks."""
    pe = world_group() if pe is None else pe
    if pe.P != P:
        raise ValueError(f"the shards are cut for P={P} PEs but the "
                         f"process group has {pe.P} ranks")
    return pe


def on_dev(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def gather_global(lab_loc: torch.Tensor, shards: GraphShards,
                  pe: PeGroup) -> np.ndarray:
    """Every PE's (n_loc,) local values -> the (n,) int64 global array,
    on every rank (one all-gather)."""
    lab = all_gather_1d(lab_loc, pe).reshape(shards.P, shards.n_loc)
    lab = lab.cpu().numpy()
    out = np.empty(shards.n, dtype=np.int64)
    valid = shards.local_gid < shards.n
    out[shards.local_gid[valid]] = lab[valid]
    return out


def _salts(num_iterations: int, B: int, mult: int, seed_mult: int,
           seed: int) -> np.ndarray:
    return (np.arange(num_iterations * B, dtype=np.uint64).reshape(
        num_iterations, B) * mult + seed * seed_mult) % (2**32)


def _dense(idx: torch.Tensor, vals: torch.Tensor, L: int) -> torch.Tensor:
    """``zeros(L).at[idx].add(vals, mode="drop")`` (int32); every index
    the engine scatters (a label, a block, a global id or its sentinel n)
    lies in the table, so nothing is dropped."""
    return segment_sum(vals, idx.long(), L)


# ---------------------------------------------------------------------------
# per-PE chunk step
# ---------------------------------------------------------------------------

def _sorted_chunk(tab, c_src, c_dst, c_w):
    lab_dst = tab[c_dst.long()]
    order = sort2(c_src, lab_dst)
    return c_src[order], lab_dst[order], c_w[order]


def _local_moves(lab_src_tab, tab, cw_like, budget_like, vw_pad, c_src,
                 c_dst, c_w, salt, n_loc, cluster_mode):
    """Shared gain/argmax stage. Returns (move, target, lab_cur) over the
    (n_loc+1,) src space. ``cw_like``/``budget_like`` are indexed by label
    value."""
    s_src, s_lab, s_w = _sorted_chunk(tab, c_src, c_dst, c_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = lab_src_tab[src_i]
    staying = s_lab == own_lab
    # ``w <= budget - c`` form: exact at the int32 boundary (w + c wraps)
    fits = cw_like[lab_i] <= budget_like[lab_i] - vw_pad[src_i]
    fits = (fits | staying) if cluster_mode else (fits & ~staying)
    score = torch.where(fits, conn, -1)
    best, target = _argmax_target(s_src, s_lab, score, cw_like[lab_i],
                                  salt, n_loc)
    own_conn = _own_connection(s_src, s_lab, s_w, lab_src_tab, n_loc)
    lab_cur = lab_src_tab
    tgt_safe = torch.where(target < I32_MAX, target, lab_cur)
    if cluster_mode:
        move = (best > own_conn) & (tgt_safe != lab_cur) & \
            (target < I32_MAX) & (best > 0)
    else:
        gain = best - own_conn
        lighter = cw_like[tgt_safe.long()] < cw_like[lab_cur.long()] - vw_pad
        move = (target < I32_MAX) & (best >= 0) & \
            ((gain > 0) | ((gain == 0) & lighter))
    move[n_loc] = False
    return move, tgt_safe, lab_cur


def _penalized_moves(lab_src_tab, tab, bw_like, budget_like, vw_pad, c_src,
                     c_dst, c_w, salt, pen_num, pen_den, n_loc):
    """Unconstrained (Jet-style) gain/argmax stage: a move whose target
    block would exceed its budget pays ``(own_conn // pen_den) * pen_num``
    off its connection. No bounce follows; the trailing balancer repairs
    feasibility."""
    s_src, s_lab, s_w = _sorted_chunk(tab, c_src, c_dst, c_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = lab_src_tab[src_i]
    staying = s_lab == own_lab
    own_conn = _own_connection(s_src, s_lab, s_w, lab_src_tab, n_loc)
    # ``w > budget - c`` form: exact at the int32 boundary (w + c wraps)
    over_after = bw_like[lab_i] > budget_like[lab_i] - vw_pad[src_i]
    pen = torch.where(over_after, torch.div(own_conn[src_i], pen_den,
                                            rounding_mode="floor") * pen_num,
                      0).to(torch.int32)
    # clamping to -1 loses nothing: a score < 0 can never pass the move
    # rule (it would need score >= own_conn >= 0)
    score = torch.where(~staying, torch.clamp(conn - pen, min=-1), -1)
    best, target = _argmax_target(s_src, s_lab, score, bw_like[lab_i],
                                  salt, n_loc)
    lab_cur = lab_src_tab
    tgt_safe = torch.where(target < I32_MAX, target, lab_cur)
    gain = best - own_conn
    lighter = bw_like[tgt_safe.long()] < bw_like[lab_cur.long()] - vw_pad
    move = (target < I32_MAX) & (best >= 0) & \
        ((gain > 0) | ((gain == 0) & lighter))
    move[n_loc] = False
    return move, tgt_safe, lab_cur


def _intra_pe_revert(move, tgt, lab_cur, vw_pad, cw, d_in, d_out, salt,
                     n_loc, num_labels, W):
    """Exact hash-ordered revert of this PE's chunk moves against its local
    weight view (port of core.lp._cluster_chunk's revert block)."""
    new_cw = cw + d_in - d_out
    new_lab = torch.where(move, tgt, lab_cur)
    over = new_cw > W
    cand = move & over[new_lab.long()]
    num = n_loc + 1
    iota = torch.arange(num, dtype=torch.int32, device=move.device)
    rk = hash32(iota, (int(salt) ^ 0x9E3779B9) & 0xFFFFFFFF)
    sort_lab = torch.where(cand, new_lab, num_labels)
    order = sort2(sort_lab, rk, k2_bits=31)
    o_lab, o_v = sort_lab[order], iota[order]
    o_vw = torch.where(o_lab < num_labels, vw_pad[o_v.long()], 0)
    csum = cumsum32(o_vw)
    grp_start = torch.ones_like(o_lab, dtype=torch.bool)
    grp_start[1:] = o_lab[1:] != o_lab[:-1]
    gid = (cumsum32(grp_start.to(torch.int32)) - 1).long()
    base = segment_min(torch.where(grp_start, csum - o_vw, I32_MAX), gid,
                       num)
    within = csum - base[gid]
    lab_safe = torch.where(o_lab < num_labels, o_lab, 0).long()
    moved_in = segment_sum(o_vw, gid, num)[gid]
    allowed = torch.clamp(W - (new_cw[lab_safe] - moved_in), min=0)
    revert = (o_lab < num_labels) & (within > allowed)
    rv = torch.zeros(num, dtype=torch.bool, device=move.device)
    rv[o_v.long()] = revert
    return move & ~rv


def _deltas(move, tgt, lab_cur, vw_pad, L):
    vw_m = torch.where(move, vw_pad, 0)
    return _dense(tgt, vw_m, L) - _dense(lab_cur, vw_m, L)


def _apply_and_sync(move, tgt, lab_cur, vw_pad, cw, num_labels, pe):
    """Scatter move deltas into the replicated label-weight table and
    all-reduce. Returns the updated weight table."""
    return cw + psum(_deltas(move, tgt, lab_cur, vw_pad, num_labels), pe)


def _bounce_back(move, tgt, lab_cur, vw_pad, cw, budget_like, num_labels,
                 pe):
    """Approximate cross-PE revert: labels that exceeded their budget after
    the all-reduce bounce this chunk's incoming moves back everywhere."""
    over = cw > budget_like
    bounce = move & over[tgt.long()]
    cw = cw + psum(_deltas(bounce, lab_cur, tgt, vw_pad, num_labels), pe)
    return move & ~bounce, cw


# --- owner-sharded weight-table protocol (weights="owner") -----------------

def _commit_to_owners(move, tgt, lab_cur, vw_pad, cw_own, L, pe, use_grid):
    """Owner-mode apply: scatter this chunk's move deltas into a transient
    dense table and reduce-scatter them onto the owners' shards."""
    return cw_own + psum_scatter_1d(_deltas(move, tgt, lab_cur, vw_pad, L),
                                    pe, use_grid=use_grid)


def _bounce_back_owner(move, tgt, lab_cur, vw_pad, cw_own, budget_own, L,
                       pe, use_grid):
    """Approximate cross-PE revert, owner-authoritative: each owner checks
    its shard against its budget slice, the overweight flags are gathered
    back, and bounced moves return their weight via a second commit."""
    over = all_gather_1d(cw_own > budget_own, pe, use_grid=use_grid)
    bounce = move & over[tgt.long()]
    cw_own = cw_own + psum_scatter_1d(
        _deltas(bounce, lab_cur, tgt, vw_pad, L), pe, use_grid=use_grid)
    return move & ~bounce, cw_own


def _fused_chunk_move(lab_src_tab, tab, cw, bud, vw_pad, c_idx, c_w, v0,
                      salt, n_loc, W, num_labels, ov=None):
    """Fused twin of ``_local_moves`` + ``_intra_pe_revert``: gather the
    chunk's ELL operands from the live tables and run the ``lp_move``
    kernel in its distributed admission form. Returns ``(move, tgt)``
    over the (n_loc+1,) src space."""
    R = c_idx.shape[0]
    dev = c_idx.device
    rows = torch.clamp(torch.arange(v0, v0 + R, device=dev), max=n_loc)
    own, vwr = lab_src_tab[rows], vw_pad[rows]   # clamp: dup rows inert
    valid = c_idx >= 0
    nlab = torch.where(valid, tab[torch.where(valid, c_idx, 0).long()], -1)
    safe = torch.where(valid, nlab, 0).long()
    ncw = torch.where(valid, cw[safe], I32_MAX)
    nbud = torch.where(valid, bud[safe], 0)
    over = None if ov is None else move_ops.overflow_operands(
        tab, cw, ov, budget=bud)
    moved, tgt = lp_move_chunk(nlab, c_w, ncw, own, vwr, W, v0, salt,
                               num_labels, nbud=nbud, overflow=over)
    # rows past the table are the reference's dropped scatter writes
    cnt = min(R, n_loc + 1 - v0)
    move = torch.zeros(n_loc + 1, dtype=torch.bool, device=dev)
    move[v0:v0 + cnt] = (moved != 0)[:cnt]
    tgt_full = lab_src_tab.clone()
    tgt_full[v0:v0 + cnt] = tgt[:cnt]
    return move, tgt_full


# ---------------------------------------------------------------------------
# distributed clustering
# ---------------------------------------------------------------------------

def dist_cluster(shards: GraphShards,
                 max_cluster_weight: int,
                 num_iterations: int = 3,
                 num_chunks: int = 8,
                 seed: int = 0,
                 use_grid: bool = True,
                 pe: PeGroup = None,
                 weights: str = "replicated",
                 kernel: str = "auto") -> np.ndarray:
    """Distributed size-constrained LP clustering over graph shards.

    Returns (n,) int64 global cluster labels (label values are vertex
    ids), on every rank. ``pe`` is the process group (default: the
    initialised default group, which must have ``shards.P`` ranks).
    ``weights`` picks the table layout and ``kernel`` the chunk-move
    implementation; every combination returns bit-identical labels."""
    P, n = shards.P, shards.n
    owner = _check_weights_mode(weights)
    _check_int32_weights(shards)
    pe = resolve_pe(pe, P)
    dev, p = pe.device, pe.rank
    fused = dispatch.resolve_kernel_mode(kernel, dev) == "fused"
    n_loc, n_ghost = shards.n_loc, shards.n_ghost
    if fused:
        ch = move_ops.build_move_chunks_dist(shards, num_chunks, p,
                                             device=dev)
        B = ch.shape[0]
        slabs = (on_dev(ch.idx, dev), on_dev(ch.w, dev))
        ovs = [None if o is None else tuple(on_dev(x, dev) for x in o)
               for o in ch.overflow]
    else:
        srcs, dsts, ws = chunk_local_arcs(shards, num_chunks)
        B = srcs.shape[1]
        slabs = tuple(on_dev(x[p], dev) for x in (srcs, dsts, ws))
    salts = _salts(num_iterations, B, 0x85EBCA6B, 1000003, seed)
    W = max(1, min(int(max_cluster_weight), _BIG))

    num_labels = n + 1           # label values are global vertex ids
    S_w = owner_table_width(num_labels, P)
    # owner mode pads the dense *transient* view so P shards tile it;
    # only the (S_w,) shard persists across chunks
    L = P * S_w if owner else num_labels
    vw_loc = on_dev(shards.vweights[p], dev)
    lgid = on_dev(shards.local_gid[p], dev)
    send_idx = on_dev(shards.send_idx[p], dev)
    recv_slot = on_dev(shards.recv_slot[p], dev)
    vw_pad = torch.cat([vw_loc, vw_loc.new_zeros(1)])
    # global per-cluster weights: every vertex starts as a singleton
    dense0 = _dense(lgid, vw_loc, L)
    budget = torch.full((L,), W, dtype=torch.int32, device=dev)
    budget[n] = -_BIG                   # the sentinel is never a target
    if owner:
        cw_state = psum_scatter_1d(dense0, pe, use_grid=use_grid)
        gidx = p * S_w + torch.arange(S_w, dtype=torch.int32, device=dev)
        cw_state = torch.where(gidx == n, _BIG, cw_state)
        budget_own = torch.where(gidx == n, -_BIG, W).to(torch.int32)
    else:
        cw_state = psum(dense0, pe)
        cw_state[n] = _BIG
    lab_loc = lgid.clone()               # own global id = own cluster
    lab_ghost = on_dev(shards.ghost_gid[p], dev)
    sentinel = torch.full((1,), n, dtype=torch.int32, device=dev)

    for it in range(num_iterations):
        for b in range(B):
            salt = int(salts[it, b])
            # owner mode: request current weights from the owners (the
            # dense views live only inside this chunk body)
            cw = all_gather_1d(cw_state, pe, use_grid=use_grid) if owner \
                else cw_state
            tab = torch.cat([lab_loc, lab_ghost, sentinel])
            lab_src_tab = torch.cat([lab_loc, sentinel])
            if fused:
                move, tgt = _fused_chunk_move(
                    lab_src_tab, tab, cw, budget, vw_pad, slabs[0][b],
                    slabs[1][b], int(ch.v0[b]), salt, n_loc, W, L, ovs[b])
                lab_cur = lab_src_tab
            else:
                c_src, c_dst, c_w = (x[b] for x in slabs)
                move, tgt, lab_cur = _local_moves(
                    lab_src_tab, tab, cw, budget, vw_pad, c_src, c_dst, c_w,
                    salt, n_loc, cluster_mode=True)
                vw_m = torch.where(move, vw_pad, 0)
                move = _intra_pe_revert(move, tgt, lab_cur, vw_pad, cw,
                                        _dense(tgt, vw_m, L),
                                        _dense(lab_cur, vw_m, L), salt,
                                        n_loc, L, W)
            if owner:
                cw_state = _commit_to_owners(move, tgt, lab_cur, vw_pad,
                                             cw_state, L, pe, use_grid)
                move, cw_state = _bounce_back_owner(
                    move, tgt, lab_cur, vw_pad, cw_state, budget_own, L,
                    pe, use_grid)
            else:
                cw_state = _apply_and_sync(move, tgt, lab_cur, vw_pad,
                                           cw_state, L, pe)
                move, cw_state = _bounce_back(move, tgt, lab_cur, vw_pad,
                                              cw_state, budget, L, pe)
            lab_loc = torch.where(move[:n_loc], tgt[:n_loc], lab_loc)
            lab_ghost = halo_exchange(lab_loc, send_idx, recv_slot, n_ghost,
                                      pe, use_grid=use_grid)
    return gather_global(lab_loc, shards, pe)


# ---------------------------------------------------------------------------
# distributed k-way refinement (size-constrained and unconstrained)
# ---------------------------------------------------------------------------

def _refine(shards, part, l_max_vec, num_iterations, num_chunks, seed,
            use_grid, pe, weights, unconstrained):
    """The shared body of ``dist_lp_refine`` / ``dist_ulp_refine``."""
    P, n = shards.P, shards.n
    owner = _check_weights_mode(weights)
    _check_int32_weights(shards)
    k = int(l_max_vec.shape[0])
    pe = resolve_pe(pe, P)
    dev, p = pe.device, pe.rank
    n_loc, n_ghost = shards.n_loc, shards.n_ghost
    srcs, dsts, ws = chunk_local_arcs(shards, num_chunks)
    B = srcs.shape[1]
    src, dst, w = (on_dev(x[p], dev) for x in (srcs, dsts, ws))
    part_pad = np.concatenate([part.astype(np.int64), [k]])  # sentinel gid=n
    salts = _salts(num_iterations, B, 0xC2B2AE35, 2654435761, seed)
    lmax32 = np.minimum(l_max_vec, _BIG).astype(np.int32)

    kk = k + 1                   # sentinel block k
    S_k = owner_table_width(kk, P)
    L = P * S_k if owner else kk
    vw_loc = on_dev(shards.vweights[p], dev)
    send_idx = on_dev(shards.send_idx[p], dev)
    recv_slot = on_dev(shards.recv_slot[p], dev)
    lab_loc = on_dev(part_pad[np.minimum(shards.local_gid[p], n)]
                     .astype(np.int32), dev)
    lab_ghost = on_dev(part_pad[np.minimum(shards.ghost_gid[p], n)]
                       .astype(np.int32), dev)
    vw_pad = torch.cat([vw_loc, vw_loc.new_zeros(1)])
    dense0 = _dense(lab_loc, vw_loc, L)
    budget = torch.cat([on_dev(lmax32, dev),
                        torch.full((L - k,), -_BIG, dtype=torch.int32,
                                   device=dev)])
    if owner:
        bw_state = psum_scatter_1d(dense0, pe, use_grid=use_grid)
        gidx = p * S_k + torch.arange(S_k, dtype=torch.int32, device=dev)
        bw_state = torch.where(gidx == k, _BIG, bw_state)
        budget_own = budget[p * S_k:(p + 1) * S_k]
    else:
        bw_state = psum(dense0, pe)
        bw_state[k] = _BIG
    sentinel = torch.full((1,), k, dtype=torch.int32, device=dev)

    for it in range(num_iterations):
        for b in range(B):
            salt = int(salts[it, b])
            bw = all_gather_1d(bw_state, pe, use_grid=use_grid) if owner \
                else bw_state
            tab = torch.cat([lab_loc, lab_ghost, sentinel])
            lab_src_tab = torch.cat([lab_loc, sentinel])
            if unconstrained:
                move, tgt, lab_cur = _penalized_moves(
                    lab_src_tab, tab, bw, budget, vw_pad, src[b], dst[b],
                    w[b], salt, it, num_iterations, n_loc)
            else:
                move, tgt, lab_cur = _local_moves(
                    lab_src_tab, tab, bw, budget, vw_pad, src[b], dst[b],
                    w[b], salt, n_loc, cluster_mode=False)
            if owner:
                bw_state = _commit_to_owners(move, tgt, lab_cur, vw_pad,
                                             bw_state, L, pe, use_grid)
                if not unconstrained:
                    move, bw_state = _bounce_back_owner(
                        move, tgt, lab_cur, vw_pad, bw_state, budget_own, L,
                        pe, use_grid)
            else:
                bw_state = _apply_and_sync(move, tgt, lab_cur, vw_pad,
                                           bw_state, L, pe)
                if not unconstrained:
                    move, bw_state = _bounce_back(move, tgt, lab_cur, vw_pad,
                                                  bw_state, budget, L, pe)
            lab_loc = torch.where(move[:n_loc], tgt[:n_loc], lab_loc)
            lab_ghost = halo_exchange(lab_loc, send_idx, recv_slot, n_ghost,
                                      pe, use_grid=use_grid)
    return gather_global(lab_loc, shards, pe)


def dist_lp_refine(shards: GraphShards,
                   part: np.ndarray,
                   l_max_vec: np.ndarray,
                   num_iterations: int = 2,
                   num_chunks: int = 8,
                   seed: int = 0,
                   use_grid: bool = True,
                   pe: PeGroup = None,
                   weights: str = "replicated") -> np.ndarray:
    """Distributed chunked LP refinement of a k-way partition.

    Same move rule as ``core.lp._refine_chunk`` (positive gain, or zero
    gain into the lighter block); block weights replicated or
    owner-sharded (``weights``), overweight blocks bouncing racing moves
    back either way. May leave the partition slightly infeasible; pair
    with a balancing pass."""
    return _refine(shards, part, l_max_vec, num_iterations, num_chunks,
                   seed, use_grid, pe, weights, unconstrained=False)


def dist_ulp_refine(shards: GraphShards,
                    part: np.ndarray,
                    l_max_vec: np.ndarray,
                    num_iterations: int = 2,
                    num_chunks: int = 8,
                    seed: int = 0,
                    use_grid: bool = True,
                    pe: PeGroup = None,
                    weights: str = "replicated") -> np.ndarray:
    """Distributed unconstrained (Jet-style) refinement of a k-way
    partition: penalty-weighted gains instead of the budget mask (the
    penalty escalates ``it / num_iterations`` round by round), no
    bounce-back. The result may overload blocks by design; callers follow
    with ``rebalance`` / ``dist_rebalance`` (the afterburner). Same
    chunking and salt streams as ``dist_lp_refine``."""
    return _refine(shards, part, l_max_vec, num_iterations, num_chunks,
                   seed, use_grid, pe, weights, unconstrained=True)
