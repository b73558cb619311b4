"""Plain PyTorch and NumPy versions of the partitioner's stages, frozen
here as the benchmark's yardstick.

Each function follows the published algorithm (dKaMinPar, arXiv:2303.01417:
size-constrained label propagation in chunks, the overweight revert,
cluster contraction, greedy global balancing) in the composed form that the
program's own plain path uses: sorts, segment sums and a sequential greedy
walk, no hand-written kernel. Integer results are exact, so the stages the
program computes with its CUDA kernels (``lp_move``, ``seg_merge``,
``bal_scores``, ``greedy_pick``) must agree with these bit for bit.

This module imports neither the program nor JAX, and takes nothing the
program made.
"""
from __future__ import annotations

import numpy as np
import torch

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)
MASK32 = 0xFFFFFFFF
NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# graphs: CSR arrays (indptr, adjncy, eweights, vweights), as numpy
# ---------------------------------------------------------------------------

def arc_tails(indptr: np.ndarray) -> np.ndarray:
    n = indptr.shape[0] - 1
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))


def permute(g, perm: np.ndarray):
    """Relabel vertices (new id of old v is perm[v]): ``(g2, inv)``."""
    n = g.indptr.shape[0] - 1
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)
    src = arc_tails(g.indptr)
    new_src = perm[src].astype(np.int64)
    new_dst = perm[g.adjncy].astype(np.int64)
    order = np.argsort(new_src * n + new_dst, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(new_src, minlength=n))
    return CSR(indptr, new_dst[order], np.asarray(g.eweights)[order],
               np.asarray(g.vweights)[inv]), inv


class CSR:
    """A graph as the four CSR arrays; ``m`` counts directed arcs."""

    def __init__(self, indptr, adjncy, eweights, vweights):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.adjncy = np.asarray(adjncy, dtype=np.int64)
        self.eweights = np.asarray(eweights, dtype=np.int64)
        self.vweights = np.asarray(vweights, dtype=np.int64)

    @classmethod
    def of(cls, g) -> "CSR":
        return cls(g.indptr, g.adjncy, g.eweights, g.vweights)

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.adjncy.shape[0])


def degree_bucket_order(g, rng: np.random.Generator,
                        chunk: int = 256) -> np.ndarray:
    """The paper's LP visiting order: exponentially spaced degree buckets,
    chunks of 256 shuffled within a bucket, vertices shuffled within a
    chunk."""
    n = g.indptr.shape[0] - 1
    deg = np.diff(g.indptr)
    bucket = np.zeros(n, dtype=np.int64)
    nz = deg > 0
    bucket[nz] = np.floor(np.log2(deg[nz])).astype(np.int64) + 1
    order = np.lexsort((rng.random(n), bucket))
    out = []
    b_sorted = bucket[order]
    boundaries = np.flatnonzero(np.diff(b_sorted)) + 1
    for seg in np.split(order, boundaries):
        n_chunks = max(1, len(seg) // chunk)
        chunks = np.array_split(seg, n_chunks)
        for i in rng.permutation(len(chunks)):
            c = chunks[i].copy()
            rng.shuffle(c)
            out.append(c)
    return np.concatenate(out) if out else np.empty(0, dtype=np.int64)


def visit_permutation(g, seed: int):
    """``(perm, g2)``: the seeded degree-bucket order as a relabelling."""
    n = g.indptr.shape[0] - 1
    order = degree_bucket_order(g, np.random.default_rng(seed))
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    g2, _ = permute(g, perm)
    return perm, g2


# ---------------------------------------------------------------------------
# int32 arithmetic as the device does it
# ---------------------------------------------------------------------------

def hash32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """uint32 hash: x * 2654435761 mod 2^32, salted, mixed, 31 bits."""
    x = x.to(torch.int64) & MASK32
    h = (x * 0x79B1 + (((x * 0x9E37) & 0xFFFF) << 16)) & MASK32
    h = h ^ (int(salt) & MASK32)
    h = h ^ (h >> 15)
    return (h & 0x7FFFFFFF).to(torch.int32)


def sort2(k1: torch.Tensor, k2: torch.Tensor, k2_bits: int = 32):
    """Permutation of a stable lexicographic sort by (k1, k2)."""
    key = (k1.to(torch.int64) << k2_bits) | k2.to(torch.int64)
    return torch.sort(key, stable=True).indices


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0).to(torch.int32)


def segment_sum(x, seg, num):
    return torch.zeros(num, dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def segment_max(x, seg, num):
    out = torch.full((num,), I32_MIN, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce="amax", include_self=True)


def segment_min(x, seg, num):
    out = torch.full((num,), I32_MAX, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce="amin", include_self=True)


def chunk_salts(num_chunks: int, seed: int, mult: int) -> list:
    return [(b * mult + int(seed)) % 2**32 for b in range(num_chunks)]


def next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def on(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


# ---------------------------------------------------------------------------
# chunks: contiguous vertex ranges of about equal arc counts
# ---------------------------------------------------------------------------

def chunk_bounds(g, num_chunks: int) -> list:
    n, m = g.n, g.m
    B = max(1, min(num_chunks, max(1, n)))
    target = (m + B - 1) // max(B, 1) if m else 1
    bounds = [0]
    for b in range(1, B):
        v = int(np.searchsorted(g.indptr, b * target, side="left"))
        bounds.append(min(max(v, bounds[-1]), n))
    bounds.append(n)
    return bounds


def arc_chunks(g, num_chunks: int):
    """``(src, dst, w, n_pad)``: (B, m_pad) int32 arc slabs of the chunks,
    padded with sentinel arcs (src = dst = n_pad, w = 0); n_pad and m_pad
    are powers of two."""
    n = g.n
    n_pad = next_pow2(n)
    bounds = chunk_bounds(g, num_chunks)
    B = len(bounds) - 1
    src = arc_tails(g.indptr)
    spans = [(int(g.indptr[bounds[b]]), int(g.indptr[bounds[b + 1]]))
             for b in range(B)]
    m_pad = next_pow2(max([1] + [a1 - a0 for a0, a1 in spans]))
    s = np.full((B, m_pad), n_pad, dtype=np.int32)
    d = np.full((B, m_pad), n_pad, dtype=np.int32)
    w = np.zeros((B, m_pad), dtype=np.int32)
    for b, (a0, a1) in enumerate(spans):
        s[b, :a1 - a0] = src[a0:a1]
        d[b, :a1 - a0] = g.adjncy[a0:a1]
        w[b, :a1 - a0] = g.eweights[a0:a1]
    return s, d, w, n_pad


# ---------------------------------------------------------------------------
# gains
# ---------------------------------------------------------------------------

def group_conns(s_src, s_lab, s_w):
    """Each arc's (src, label) group weight; arcs sorted by (src, label)."""
    newgrp = torch.ones_like(s_src, dtype=torch.bool)
    newgrp[1:] = (s_src[1:] != s_src[:-1]) | (s_lab[1:] != s_lab[:-1])
    gid = (cumsum32(newgrp.to(torch.int32)) - 1).long()
    return segment_sum(s_w, gid, s_w.shape[0])[gid]


def argmax_target(s_src, s_lab, score, weight_key, salt, n,
                  full_ties=True):
    """Per-src best score, ties to the lighter weight key, then the smaller
    hash of the label, then the smaller label: ``(best, target)``.
    ``full_ties=False`` breaks ties by the label alone (the benchmark's
    control)."""
    num = n + 1
    idx = s_src.long()
    best = segment_max(score, idx, num)
    is_best = score == best[idx]
    if not full_ties:
        return best, segment_min(torch.where(is_best, s_lab, I32_MAX), idx,
                                 num)
    light = segment_min(torch.where(is_best, weight_key, I32_MAX), idx, num)
    is_best &= weight_key == light[idx]
    h = hash32(s_lab, salt)
    hbest = segment_min(torch.where(is_best, h, I32_MAX), idx, num)
    is_best &= h == hbest[idx]
    target = segment_min(torch.where(is_best, s_lab, I32_MAX), idx, num)
    return best, target


def own_connection(s_src, s_lab, s_w, labels, n):
    idx = s_src.long()
    return segment_sum(torch.where(s_lab == labels[idx], s_w, 0), idx, n + 1)


def sorted_slab(labels, c_src, c_dst, c_w):
    lab_dst = labels[c_dst.long()]
    order = sort2(c_src, lab_dst)
    return c_src[order], lab_dst[order], c_w[order]


def revert_overweight(move, new_labels, vweights, new_cw, W, salt, num,
                      num_labels):
    """The paper's overweight revert: of the vertices that moved into a
    label now above W, in hash order, those beyond the label's room go
    back. Returns the reverted flags over the (num,) vertex space."""
    over = new_cw > W
    cand = move & over[new_labels.long()]
    iota = torch.arange(num, dtype=torch.int32, device=move.device)
    rk = hash32(iota, (int(salt) ^ 0x9E3779B9) & MASK32)
    sort_lab = torch.where(cand, new_labels, num_labels)
    order = sort2(sort_lab, rk, k2_bits=31)
    o_lab, o_v = sort_lab[order], iota[order]
    o_vw = torch.where(o_lab < num_labels, vweights[o_v.long()], 0)
    csum = cumsum32(o_vw)
    grp_start = torch.ones_like(o_lab, dtype=torch.bool)
    grp_start[1:] = o_lab[1:] != o_lab[:-1]
    gid = (cumsum32(grp_start.to(torch.int32)) - 1).long()
    base = segment_min(torch.where(grp_start, csum - o_vw, I32_MAX), gid,
                       num)
    within = csum - base[gid]
    lab_safe = torch.where(o_lab < num_labels, o_lab, 0).long()
    allowed = torch.clamp(
        W - (new_cw[lab_safe] - segment_sum(o_vw, gid, num)[gid]), min=0)
    revert = (o_lab < num_labels) & (within > allowed)
    rv = torch.zeros(num, dtype=torch.bool, device=move.device)
    rv[o_v.long()] = revert
    return rv


# ---------------------------------------------------------------------------
# size-constrained LP clustering (coarsening)
# ---------------------------------------------------------------------------

def cluster_chunk(labels, cluster_w, c_src, c_dst, c_w, vweights, W, salt,
                  n, full_ties=True):
    """One chunk of clustering: every vertex of the chunk moves to the
    label it is most connected to among those with room (its own counts
    as room), then the overweight revert."""
    s_src, s_lab, s_w = sorted_slab(labels, c_src, c_dst, c_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = group_conns(s_src, s_lab, s_w)
    staying = s_lab == labels[src_i]
    fits = ((cluster_w[lab_i] + vweights[src_i]) <= W) | staying
    score = torch.where(fits, conn, -1)
    best, target = argmax_target(s_src, s_lab, score, cluster_w[lab_i],
                                 salt, n, full_ties)
    own_conn = own_connection(s_src, s_lab, s_w, labels, n)
    move = (best > own_conn) & (target != labels) & (target < I32_MAX) \
        & (best > 0)
    move[n] = False
    new_labels = torch.where(move, target, labels)
    vw_moved = torch.where(move, vweights, 0)
    num = n + 1
    new_cw = cluster_w + segment_sum(vw_moved, new_labels.long(), num) \
        - segment_sum(vw_moved, labels.long(), num)
    rv = revert_overweight(move, new_labels, vweights, new_cw, W, salt,
                           num, num) & move
    vw_rv = torch.where(rv, vweights, 0)
    return (torch.where(rv, labels, new_labels),
            new_cw + segment_sum(vw_rv, labels.long(), num)
            - segment_sum(vw_rv, new_labels.long(), num))


def ejection_candidates(labels, vweights, max_weight):
    """Members that leave an overweight cluster: sorted by (cluster,
    -weight, id), a member goes once the kept weight with it exceeds W,
    never a cluster's first (heaviest) member."""
    n = labels.shape[0]
    cw = np.zeros(n, dtype=np.int64)
    np.add.at(cw, labels, vweights)
    over = cw > max_weight
    if not over.any():
        return np.empty(0, dtype=np.int64)
    members = np.flatnonzero(over[labels])
    order = np.lexsort((members, -vweights[members], labels[members]))
    sid = labels[members][order]
    sw = vweights[members][order]
    csum = np.cumsum(sw)
    starts = np.concatenate([[True], sid[1:] != sid[:-1]])
    gidx = np.cumsum(starts) - 1
    gstart = np.flatnonzero(starts)
    within = csum - (csum[gstart] - sw[gstart])[gidx]
    return members[order][(within > max_weight) & ~starts].astype(np.int64)


def enforce_cluster_weights(labels, vweights, max_weight):
    """Ejected members take the smallest unused cluster ids, in order."""
    n = labels.shape[0]
    ej = ejection_candidates(labels, vweights, max_weight)
    if ej.size == 0:
        return labels
    used = np.zeros(n, dtype=bool)
    used[labels[np.setdiff1d(np.arange(n), ej)]] = True
    free = np.flatnonzero(~used)
    out = labels.copy()
    out[ej] = free[:ej.size]
    return out


def cluster(g, W: int, num_iterations: int, num_chunks: int, seed: int,
            dev, full_ties=True) -> np.ndarray:
    """Size-constrained LP clustering of ``g``: labels in g's numbering.
    ``full_ties=False`` breaks ties by the label alone (the benchmark's
    control)."""
    g = CSR.of(g)
    n = g.n
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    perm, g2 = visit_permutation(g, seed)
    W = max(1, int(W))
    s, d, w, n_pad = arc_chunks(g2, num_chunks)
    labels = torch.arange(n_pad + 1, dtype=torch.int32, device=dev)
    vw_np = np.zeros(n_pad + 1, dtype=np.int32)
    vw_np[:n] = g2.vweights
    vw = on(vw_np, dev)
    cw = vw.clone()
    s, d, w = on(s, dev), on(d, dev), on(w, dev)
    for it in range(num_iterations):
        salt0 = (seed * 1000003 + it) % 2**32
        for b, salt in enumerate(chunk_salts(s.shape[0], salt0,
                                             0x85EBCA6B)):
            labels, cw = cluster_chunk(labels, cw, s[b], d[b], w[b], vw, W,
                                       salt, n_pad, full_ties)
    lab2 = labels.cpu().numpy()[:n].astype(np.int64)
    return enforce_cluster_weights(lab2, g2.vweights, W)[perm]


# ---------------------------------------------------------------------------
# contraction
# ---------------------------------------------------------------------------

def contract(g, labels):
    """``(coarse, mapping)``: clusters numbered in the order of their
    labels, and the quotient graph by that numbering."""
    uniq, mapping = np.unique(labels, return_inverse=True)
    mapping = mapping.astype(np.int64)
    return quotient(g, mapping, int(uniq.size)), mapping


def quotient(g, mapping: np.ndarray, nc: int) -> CSR:
    """The graph of ``g`` contracted by ``mapping`` (fine -> coarse id):
    coarse vertex weights summed, self loops dropped, parallel arcs merged
    by summed weight, arcs in (tail, head) order."""
    g = CSR.of(g)
    cvw = np.bincount(mapping, weights=g.vweights, minlength=nc)
    cs = mapping[arc_tails(g.indptr)]
    cd = mapping[g.adjncy]
    keep = cs != cd
    cs, cd, w = cs[keep], cd[keep], g.eweights[keep]
    order = np.lexsort((cd, cs))
    cs, cd, w = cs[order], cd[order], w[order]
    first = np.ones(cs.shape[0], dtype=bool)
    first[1:] = (cs[1:] != cs[:-1]) | (cd[1:] != cd[:-1])
    seg = np.cumsum(first) - 1
    ww = np.bincount(seg, weights=w, minlength=int(first.sum())) \
        if cs.size else np.zeros(0)
    indptr = np.zeros(nc + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(cs[first], minlength=nc))
    return CSR(indptr, cd[first], np.rint(ww).astype(np.int64),
               np.rint(cvw).astype(np.int64))


# ---------------------------------------------------------------------------
# block tables
# ---------------------------------------------------------------------------

def pad_blocks(block_w, l_max_vec, parent, min_bucket: int = 64):
    """Block tables padded to a power of two >= 64 with unreachable dummy
    blocks (int32 max weight and budget, their own parent)."""
    big = 2**31 - 1
    k = int(block_w.shape[0])
    k_pad = max(min_bucket, 1 << max(0, (k - 1)).bit_length())
    bw = np.full(k_pad, big, dtype=np.int32)
    bw[:k] = block_w
    lv = np.full(k_pad, big, dtype=np.int32)
    lv[:k] = np.minimum(l_max_vec, big)
    pr = np.arange(k_pad, dtype=np.int32)
    pr[:k] = parent if parent is not None else np.arange(k)
    return bw, lv, pr


# ---------------------------------------------------------------------------
# greedy global balancing
# ---------------------------------------------------------------------------

def fallback_table(block_w, parent, restricted: bool):
    """Each block's fallback target: the lightest block (restricted: the
    lightest sibling), ties to the smaller id."""
    k = block_w.shape[0]
    ids = torch.arange(k, dtype=torch.int32, device=block_w.device)
    if restricted:
        p = parent.long()
        grp_min = segment_min(block_w, p, k)
        bid = torch.where(block_w == grp_min[p], ids, I32_MAX)
        return segment_min(bid, p, k)[p]
    first_min = torch.where(block_w == block_w.min(), ids, I32_MAX).min()
    return first_min.expand(k).contiguous()


def balance_gains(labels, s_src, s_lab, s_w, block_w, l_max, parent, vw,
                  salt, n, valid, restricted):
    """Relative gain (g * c(v) for g >= 0, else g / c(v), float32) and
    target of every vertex of an overloaded block; -inf where it must not
    move. The target is the best admissible adjacent block, else the
    fallback block."""
    over = block_w > l_max
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = group_conns(s_src, s_lab, s_w)
    own_lab = labels[src_i]
    ok = (block_w[lab_i] <= l_max[lab_i] - vw[src_i]) & (s_lab != own_lab)
    if restricted:
        ok &= parent[lab_i] == parent[own_lab.long()]
    score = torch.where(ok, conn, -1)
    best, target = argmax_target(s_src, s_lab, score, block_w[lab_i], salt,
                                 n)
    own_conn = own_connection(s_src, s_lab, s_w, labels, n)
    has_adj = (best >= 0) & (target < I32_MAX)
    fb_t = fallback_table(block_w, parent, restricted)[labels.long()]
    fb_l = fb_t.long()
    fb_ok = (block_w[fb_l] <= l_max[fb_l] - vw) & (fb_t != labels)
    tgt = torch.where(has_adj, torch.where(has_adj, target, 0), fb_t)
    g = torch.where(has_adj, best - own_conn, -own_conn)
    movable = over[labels.long()] & (has_adj | fb_ok) & valid
    gf = g.to(torch.float32)
    cv = torch.clamp(vw.to(torch.float32), min=1.0)
    rel = torch.where(g >= 0, gf * cv, gf / cv)
    return torch.where(movable, rel, NEG_INF), tgt


def greedy_pick(vals, tgt_blk, src_blk, cand_w, block_w, l_max):
    """The ranked pool applied in order: a move is taken while its source
    is overloaded and its target stays within budget (int32 wrap)."""
    vals_l, t_l = vals.tolist(), tgt_blk.tolist()
    b_l, c_l = src_blk.tolist(), cand_w.tolist()
    bw, lm = block_w.tolist(), l_max.tolist()
    K = len(bw)
    accept = []

    def wrap(x):
        return (x + 2**31) % 2**32 - 2**31

    for v, t, b, c in zip(vals_l, t_l, b_l, c_l):
        tc, bc = min(max(t, 0), K - 1), min(max(b, 0), K - 1)
        ok = v > NEG_INF and bw[bc] > lm[bc] and \
            bw[tc] <= wrap(lm[tc] - c) and t != b
        if ok:
            if 0 <= b < K:
                bw[b] = wrap(bw[b] - c)
            if 0 <= t < K:
                bw[t] = wrap(bw[t] + c)
        accept.append(ok)
    dev = block_w.device
    return (torch.tensor(accept, dtype=torch.bool, device=dev),
            torch.tensor(bw, dtype=torch.int32, device=dev))


def rebalance(g, part, l_max_vec, parent=None, top_m: int = 128,
              max_rounds: int = 200, seed: int = 0, dev="cpu",
              rounds_out=None) -> np.ndarray:
    """Balance rounds until every block is within its budget. A round
    ranks the movable vertices by relative gain (descending, ties to the
    lower id), keeps the best ``top_m`` and applies them greedily.
    ``rounds_out``, a list, receives per round ``(rows, arcs)`` of the
    vertices in blocks overloaded at the round's start."""
    g = CSR.of(g)
    n, k = g.n, int(l_max_vec.shape[0])
    part = np.asarray(part, dtype=np.int64)
    block_w = np.rint(np.bincount(part, weights=g.vweights, minlength=k)
                      ).astype(np.int64)
    if not bool(np.any(block_w > l_max_vec)):
        return part.copy()
    s, d, w, n_pad = arc_chunks(g, 1)
    top_m = min(top_m, n_pad + 1)
    labels = np.zeros(n_pad + 1, dtype=np.int32)
    labels[:n] = part
    vw = np.zeros(n_pad + 1, dtype=np.int32)
    vw[:n] = g.vweights
    bw, lv, pr = pad_blocks(block_w, l_max_vec, parent)
    labels_t, vw_t = on(labels, dev), on(vw, dev)
    bw_t, lv_t, pr_t = on(bw, dev), on(lv, dev), on(pr, dev)
    valid = on(np.arange(n_pad + 1) < n, dev)
    src, dst, ww = on(s[0], dev), on(d[0], dev), on(w[0], dev)
    deg = on(np.diff(g.indptr), dev)
    restricted = parent is not None
    for r in range(max_rounds):
        salt = (seed * 7919 + r) % 2**32
        if rounds_out is not None:
            rows = (bw_t > lv_t)[labels_t[:n].long()]
            rounds_out.append((int(rows.sum()), int(deg[rows].sum())))
        order = sort2(src, labels_t[dst.long()])
        rel, tgt = balance_gains(labels_t, src[order],
                                 labels_t[dst.long()][order], ww[order],
                                 bw_t, lv_t, pr_t, vw_t, salt, n_pad, valid,
                                 restricted)
        vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
        t_v, l_v = tgt[vidx], labels_t[vidx]
        accept, bw_t = greedy_pick(rel[vidx], t_v, l_v, vw_t[vidx], bw_t,
                                   lv_t)
        labels_t[vidx] = torch.where(accept, t_v, l_v)
        if not bool((bw_t > lv_t).any()):
            break
    return labels_t[:n].cpu().numpy().astype(np.int64)
