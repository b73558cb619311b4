"""Hub rows: the capped ELL slab plus per-chunk overflow, against the
whole row and against the JAX package.

``kernels/lp_move/ops.py::slab_width`` caps the slab's width; a row of a
larger degree keeps its first D arcs in the slab and the rest in an
overflow CSR, which the kernels' heavy-row paths (and their plain
versions, run here on the CPU) take over the whole row. Tolerance: the
results are integers (and one f32 gain from an int32), compared exactly.

* the split plain versions of ``lp_move`` and ``bal_scores`` against the
  same chunk held as whole rows (and the JAX package's oracles), on
  seeded random chunks whose hub rows have labels on both sides of the
  cap, one of 3,000 arcs, and one with no admissible target;
* the heavy-row plan (``kernels/heavy.py``: warp-class rows, hub rows cut
  into lane ranges) against the thresholds of ``csrc/common.cuh``, every
  heavy lane taken exactly once, and the split twins on the rows the plan
  cuts: rows of D + 1 lanes, rows at each class boundary, a 30,000-arc
  row whose labels span its ranges, labels tied on connectivity and
  weight across ranges, no admissible target, and K beyond a warp's
  table (both admission forms of ``lp_move``, both forms of
  ``bal_scores``);
* ba and rhg at n=4000 with the slab forced to 8 lanes, so that most
  rows overflow: the port's fused path (the split plain versions) against
  the reference's composed ``cluster``, ``rebalance`` and
  ``Partitioner.run`` (labels, cut, trace);
* ``EllTooLarge`` on ba n=4000 under a forced small byte limit, and a
  stacked level-0 group whose hub request is served solo.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import balance as ref_balance  # noqa: E402
from repro.core import coarsening as ref_coarsening  # noqa: E402
from repro.core.deep_mgp import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro.kernels.bal_round import ref as ref_bal_ref  # noqa: E402
from repro.kernels.lp_move import ref as ref_lp_ref  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.analysis import limits  # noqa: E402
from repro_torch.core import balance, coarsening  # noqa: E402
from repro_torch.core.deep_mgp import level0_cluster_plan  # noqa: E402
from repro_torch.kernels import _build, dispatch, heavy  # noqa: E402
from repro_torch.kernels.bal_round import ops as bal_ops  # noqa: E402
from repro_torch.kernels.bal_round.ref import bal_scores_ell_ref  # noqa: E402
from repro_torch.kernels.lp_move import ops as move_ops  # noqa: E402
from repro_torch.kernels.lp_move.ref import lp_move_chunk_ref  # noqa: E402
from repro_torch.serve import batching  # noqa: E402

CPU = torch.device("cpu")
I32_MAX = 2**31 - 1
CFG = RefConfig(contraction_limit=256, ip_repetitions=2, num_chunks=4)


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def graphs(family, n, seed=17):
    g = ref_generators.make(family, n, 8.0, seed=seed)
    return g, carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                      g.vweights)


@pytest.fixture
def small_slab(monkeypatch):
    """Slabs of 8 lanes whatever the degrees: most rows overflow."""
    monkeypatch.setattr(move_ops, "LANE", 8)
    monkeypatch.setattr(move_ops, "SLAB_ARC_FACTOR", 0)


def random_csr(rng, R, degs, n_ids):
    """CSR rows of the given degrees over ids [0, n_ids)."""
    indptr = np.zeros(R + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(degs)
    adj = rng.integers(0, n_ids, int(indptr[-1])).astype(np.int64)
    w = rng.integers(1, 6, int(indptr[-1])).astype(np.int64)
    return indptr, adj, w


def whole_and_split(indptr, adj, w, R, D):
    """The same rows as whole-row (R, Dmax) tables and as (R, D) slabs
    plus overflow."""
    deg = np.diff(indptr)
    full = max(int(deg.max()), 1)
    wi = np.full((R, full), -1, np.int32)
    ww = np.zeros((R, full), np.int32)
    assert move_ops.ell_rows(indptr, adj, w, 0, R, wi, ww) is None
    si = np.full((R, D), -1, np.int32)
    sw = np.zeros((R, D), np.int32)
    ov = move_ops.ell_rows(indptr, adj, w, 0, R, si, sw)
    return (wi, ww), (si, sw), ov


def split_label(ov, slab_ids, lab):
    """Whether a heavy row carries one label in its slab and its
    overflow."""
    for h, r in enumerate(ov.rows):
        a, b = ov.ptr[h], ov.ptr[h + 1]
        if set(lab[slab_ids[r]].tolist()) & set(lab[ov.idx[a:b]].tolist()):
            return True
    return False


# degrees of the chunk's rows: light rows, hubs around the cap, one of
# 3,000 arcs (the whole-row JAX oracle skips that one: an (R, D, D) cube)
@pytest.mark.parametrize("seed,hub", [(0, 300), (1, 120), (2, 3000),
                                      (3, 60)])
def test_lp_move_split_matches_whole_row(seed, hub):
    rng = np.random.default_rng(seed)
    R, D, n_labels, W = 48, 32, 40, 30
    degs = rng.integers(0, D + 1, R)
    degs[[3, 17, 30]] = (hub, D + 1, 2 * D)
    degs[-3:] = 0                                    # padded tail rows
    indptr, adj, w = random_csr(rng, R, degs, 500)
    lab = rng.integers(0, n_labels, 500).astype(np.int32)
    cw = rng.integers(0, 2 * W, n_labels).astype(np.int32)
    cw[lab[adj[indptr[17]:indptr[18]]]] = W + 10      # row 17: nothing fits
    own = rng.integers(0, n_labels, R).astype(np.int32)
    own[17] = n_labels + 1                           # ... and no own label
    vw = rng.integers(1, 4, R).astype(np.int32)
    (wi, ww), (si, sw), ov = whole_and_split(indptr, adj, w, R, D)
    assert set(ov.rows.tolist()) == {3, 17, 30}
    assert split_label(ov, si, lab)

    def operands(ids):
        valid = ids >= 0
        nlab = np.where(valid, lab[np.maximum(ids, 0)], -1).astype(np.int32)
        ncw = np.where(valid, cw[np.maximum(nlab, 0)], I32_MAX)
        return nlab, ncw.astype(np.int32)

    v0, salt, nl = 40, int(rng.integers(0, 2**32)), n_labels + 2
    nlab, ncw = operands(wi)
    whole = lp_move_chunk_ref(t32(nlab), t32(ww), t32(ncw), t32(own),
                              t32(vw), W, v0, salt, nl)
    s_lab, s_cw = operands(si)
    o_lab = lab[ov.idx]
    over = (t32(ov.rows), t32(ov.ptr), t32(o_lab), t32(ov.w),
            t32(cw[o_lab]))
    split = lp_move_chunk_ref(t32(s_lab), t32(sw), t32(s_cw), t32(own),
                              t32(vw), W, v0, salt, nl, overflow=over)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert whole[0][[3, 30]].any() and not whole[0][17]
    if hub <= 300:
        scal = np.array([[W, v0]], np.int32)
        r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
            *(jnp.asarray(x) for x in (nlab, ww, ncw, own[:, None],
                                       vw[:, None], scal)),
            jnp.asarray(np.array([[salt]], np.uint32)))
        np.testing.assert_array_equal(whole[0].numpy(),
                                      np.asarray(r_moved)[:, 0])
        np.testing.assert_array_equal(whole[1].numpy(),
                                      np.asarray(r_tgt)[:, 0])


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_bal_scores_split_matches_whole_row(seed, restricted):
    rng = np.random.default_rng(seed)
    R, D, K = 64, 32, 12
    degs = rng.integers(0, D + 1, R)
    degs[[2, 9, 40]] = (250, D + 3, 3 * D)
    indptr, adj, w = random_csr(rng, R, degs, R)
    labels = rng.integers(0, K, R).astype(np.int32)
    labels[rng.random(R) < 0.4] = 0                  # one crowded block
    vw = rng.integers(1, 4, R).astype(np.int32)
    bw = rng.integers(0, 40, K).astype(np.int32)
    lm = rng.integers(10, 40, K).astype(np.int32)
    fb = rng.integers(0, K, K).astype(np.int32)
    par = rng.integers(0, K // 2, K).astype(np.int32) if restricted else None
    (wi, ww), (si, sw), ov = whole_and_split(indptr, adj, w, R, D)
    assert split_label(ov, si, labels)
    tabs = [t32(x) for x in (labels, vw, bw, lm, fb)]
    salt, n = int(rng.integers(0, 2**32)), R - 4
    kw = {"parent": None if par is None else t32(par)}
    whole = bal_scores_ell_ref(t32(wi), t32(ww), *tabs, n, salt, **kw)
    split = bal_scores_ell_ref(t32(si), t32(sw), *tabs, n, salt, **kw,
                               overflow=tuple(t32(x) for x in ov))
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the whole rows against the JAX oracle, operands gathered with numpy
    valid = wi >= 0
    nlab = np.where(valid, labels[np.maximum(wi, 0)], -1).astype(np.int32)
    nl = np.maximum(nlab, 0)
    fb_t = fb[labels]
    cols = [labels, vw, bw[labels] > lm[labels], np.arange(R) < n, fb_t,
            (bw[fb_t] <= lm[fb_t] - vw) & (fb_t != labels)]
    jargs = [jnp.asarray(x) for x in (nlab, ww, bw[nl], lm[nl])]
    jargs += [jnp.asarray(c.astype(np.int32)[:, None]) for c in cols]
    jargs.append(jnp.asarray(np.array([[salt]], dtype=np.uint32)))
    jkw = {} if par is None else {"npar": jnp.asarray(par[nl]),
                                  "opar": jnp.asarray(par[labels][:, None])}
    rel, tgt = ref_bal_ref.bal_scores_ref(*jargs, **jkw,
                                          restricted=restricted)
    np.testing.assert_array_equal(whole[0].numpy(), np.asarray(rel)[:, 0])
    np.testing.assert_array_equal(whole[1].numpy(), np.asarray(tgt)[:, 0])


# ---------------------------------------------------------------------------
# the heavy-row plan and the split twins on the rows it cuts
# ---------------------------------------------------------------------------

def kernel_split(lanes, hubs, ranges):
    """The kernels' walk of a plan: {(heavy row, lane): work item}, warp
    h taking warp-class row h whole, hub CTA c the lanes [c HUB_RANGE,
    (c + 1) HUB_RANGE) of the hub-lane space from hub row ranges[c] on
    (item H + c); and the CTAs each hub row counts for its ticket."""
    H, n_hub = lanes.size, hubs.shape[0] - 1
    HL = int(hubs[-1, 1])
    got = {(h, p): h for h in range(H) if lanes[h] <= heavy.WARP_LANES
           for p in range(lanes[h])}
    ctas = {}
    for c in range(ranges.size):
        x0, x1 = c * heavy.HUB_RANGE, min((c + 1) * heavy.HUB_RANGE, HL)
        k = int(ranges[c])
        while k < n_hub and hubs[k, 1] < x1:
            off, end = int(hubs[k, 1]), int(hubs[k + 1, 1])
            h = int(hubs[k, 0])
            for lane in range(max(x0, off), min(x1, end)):
                assert (h, lane - off) not in got
                got[(h, lane - off)] = H + c
            ctas[k] = ctas.get(k, 0) + 1
            k += 1
    return got, ctas


@pytest.mark.parametrize("lanes", [
    [33], [256, 257], [257, 767, 1025, 33, 2049], [30000, 40, 300, 1024],
    "random"])
def test_heavy_plan_covers_every_lane(lanes):
    """Every heavy lane lies in exactly one work item, the classes follow
    the thresholds the CUDA sources state, each hub row counts the CTAs
    that take it, and the plain versions' split (``lane_items``) is the
    plan's."""
    c = limits.cu_constants("common.cuh")
    assert (heavy.WARP_LANES, heavy.HUB_RANGE) == (c["WARP_LANES"],
                                                    c["HUB_RANGE"])
    if lanes == "random":
        rng = np.random.default_rng(5)
        lanes = rng.integers(33, 3 * heavy.HUB_RANGE, 40)
    lanes = np.asarray(lanes, dtype=np.int64)
    hubs, ranges = heavy.heavy_plan(lanes)
    hub = lanes > heavy.WARP_LANES
    np.testing.assert_array_equal(hubs[:-1, 0], np.flatnonzero(hub))
    assert tuple(hubs[-1]) == (lanes.size, lanes[hub].sum())
    np.testing.assert_array_equal(np.diff(hubs[:, 1]), lanes[hub])
    assert ranges.size == -(-int(lanes[hub].sum()) // heavy.HUB_RANGE)
    got, ctas = kernel_split(lanes, hubs, ranges)
    assert sorted(got) == [(h, p) for h in range(lanes.size)
                           for p in range(lanes[h])]
    for k in range(hubs.shape[0] - 1):       # csrc/common.cuh::hub_ctas
        off, end = int(hubs[k, 1]), int(hubs[k + 1, 1])
        assert ctas[k] == (end - 1) // heavy.HUB_RANGE \
            - off // heavy.HUB_RANGE + 1
    hid = torch.tensor([h for h, _ in got])
    pos = torch.tensor([p for _, p in got])
    items = heavy.lane_items(hid, pos, torch.from_numpy(lanes))
    assert items.tolist() == list(got.values())


D_HUB = 32
# hub-row cases: (degrees of the heavy rows, labels (blocks) they draw
# from); the other rows of the chunk are light. "class edges": 256 and 257
# lanes, then hub rows 257 + 767 = 1024 lanes that end on a range
# boundary, one of 1025 and one of D + 1; "ties": two labels with equal
# connectivity and weight in one hub row, each in another range
SPLIT_CASES = {"d_plus_1": ([D_HUB + 1] * 4, 12),
               "class_edges": ([256, 257, 767, 1025, D_HUB + 1], 40),
               "hub_30000": ([30000, 300], 20),
               "ties": ([700, 600], 4000),
               "no_target": ([1100, 40], 30),
               "k_beyond_table": ([256, 1100, 90], 1 << 20)}


def split_chunk(rng, case):
    """A chunk of 24 rows whose heavy rows (first, in order) have the
    case's degrees, over neighbour ids [0, 30000 + 4000): its CSR, the
    label of each id, and in "ties" the two tied labels (ids 30000 ..
    30099 carry the first, 31000 .. 31099 the second, in hub row 1 at
    lanes 0-99 and 400-499: hub-lane ranges 0 and 1)."""
    degs_h, n_lab = SPLIT_CASES[case]
    R = 24
    degs = rng.integers(0, D_HUB + 1, R)
    degs[:len(degs_h)] = degs_h
    degs[-2:] = 0
    N = 34000
    indptr = np.zeros(R + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(degs)
    adj = rng.integers(0, 30000, int(indptr[-1]))
    w = rng.integers(1, 6, int(indptr[-1]))
    lab = rng.integers(0, n_lab, N).astype(np.int32)
    tied = None
    if case == "ties":
        a = int(indptr[1])
        adj[a:a + 600] = np.arange(30100, 30700)
        adj[a:a + 100] = np.arange(30000, 30100)
        adj[a + 400:a + 500] = np.arange(31000, 31100)
        w[a:a + 600] = 1
        lab[30100:30700] = np.arange(600) + 10     # distinct: conn 1 each
        tied = (n_lab - 1, n_lab - 2)
        lab[30000:30100], lab[31000:31100] = tied
    return R, indptr, adj, w, lab, tied


def lp_split_against_whole(R, indptr, adj, w, lab, cw, own, vw, W, salt,
                           nbud_of=None, jax_oracle=True):
    """lp_move's split twin (slab + overflow, the kernel's split) against
    its whole-row twin and, if ``jax_oracle``, the JAX package's oracle on
    the whole rows; ``nbud_of``: the labels' budgets (the distributed
    admission form). Returns the whole-row (moved, tgt)."""
    (wi, ww), (si, sw), ov = whole_and_split(indptr, adj, w, R, D_HUB)
    nl = len(cw)

    def operands(ids):
        valid = ids >= 0
        nlab = np.where(valid, lab[np.maximum(ids, 0)], -1).astype(np.int32)
        safe = np.maximum(nlab, 0)
        out = [nlab, np.where(valid, cw[safe], I32_MAX).astype(np.int32)]
        if nbud_of is not None:
            out.append(np.where(valid, nbud_of[safe], 0).astype(np.int32))
        return out

    v0 = 40
    whole_ops, split_ops = operands(wi), operands(si)
    kw = {} if nbud_of is None else {"nbud": t32(whole_ops[2])}
    whole = lp_move_chunk_ref(t32(whole_ops[0]), t32(ww), t32(whole_ops[1]),
                              t32(own), t32(vw), W, v0, salt, nl, **kw)
    o_lab = lab[ov.idx]
    over = [ov.rows, ov.ptr, o_lab, ov.w, cw[o_lab]]
    if nbud_of is not None:
        over.append(nbud_of[o_lab])
        kw = {"nbud": t32(split_ops[2])}
    over += [ov.hubs, ov.ranges]
    split = lp_move_chunk_ref(t32(split_ops[0]), t32(sw), t32(split_ops[1]),
                              t32(own), t32(vw), W, v0, salt, nl,
                              overflow=tuple(t32(x) for x in over), **kw)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if jax_oracle:
        scal = np.array([[W, v0]], np.int32)
        jkw = {} if nbud_of is None else {
            "nbud": jnp.asarray(whole_ops[2]), "fit_sum": False}
        r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
            *(jnp.asarray(x) for x in (whole_ops[0], ww, whole_ops[1],
                                       own[:, None], vw[:, None], scal)),
            jnp.asarray(np.array([[salt]], np.uint32)), **jkw)
        np.testing.assert_array_equal(whole[0].numpy(),
                                      np.asarray(r_moved)[:, 0])
        np.testing.assert_array_equal(whole[1].numpy(),
                                      np.asarray(r_tgt)[:, 0])
    return whole


def bal_split_against_whole(R, indptr, adj, w, labels, vw, bw, lm, fb, par,
                            salt, n, jax_oracle=True):
    """bal_scores' split twin against its whole-row twin and, if
    ``jax_oracle``, the JAX oracle on the whole rows (operands gathered
    with numpy). ``labels`` has one entry a row (ids index the rows).
    Returns the whole-row (rel, tgt)."""
    (wi, ww), (si, sw), ov = whole_and_split(indptr, adj, w, R, D_HUB)
    tabs = [t32(x) for x in (labels, vw, bw, lm, fb)]
    kw = {"parent": None if par is None else t32(par)}
    whole = bal_scores_ell_ref(t32(wi), t32(ww), *tabs, n, salt, **kw)
    split = bal_scores_ell_ref(t32(si), t32(sw), *tabs, n, salt, **kw,
                               overflow=tuple(t32(x) for x in ov))
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if jax_oracle:
        valid = wi >= 0
        nlab = np.where(valid, labels[np.maximum(wi, 0)], -1)
        nlab = nlab.astype(np.int32)
        nl = np.maximum(nlab, 0)
        fb_t = fb[labels]
        cols = [labels, vw, bw[labels] > lm[labels], np.arange(R) < n, fb_t,
                (bw[fb_t] <= lm[fb_t] - vw) & (fb_t != labels)]
        jargs = [jnp.asarray(x) for x in (nlab, ww, bw[nl], lm[nl])]
        jargs += [jnp.asarray(c.astype(np.int32)[:, None]) for c in cols]
        jargs.append(jnp.asarray(np.array([[salt]], dtype=np.uint32)))
        jkw = {} if par is None else {
            "npar": jnp.asarray(par[nl]),
            "opar": jnp.asarray(par[labels][:, None])}
        rel, tgt = ref_bal_ref.bal_scores_ref(*jargs, **jkw,
                                              restricted=par is not None)
        np.testing.assert_array_equal(whole[0].numpy(),
                                      np.asarray(rel)[:, 0])
        np.testing.assert_array_equal(whole[1].numpy(),
                                      np.asarray(tgt)[:, 0])
    return whole


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_heavy_split_cases(case):
    """The split twins of both kernels on the rows the heavy-row plan
    cuts, bit-identical to the whole rows and (up to rows of 1,100 lanes;
    the oracle builds an (R, D, D) cube) to the JAX package's oracles:
    lp_move in both admission forms, bal_scores unrestricted and
    restricted."""
    rng = np.random.default_rng(sorted(SPLIT_CASES).index(case))
    R, indptr, adj, w, lab, tied = split_chunk(rng, case)
    degs = np.diff(indptr)
    _, _, ov = whole_and_split(indptr, adj, w, R, D_HUB)
    lanes = degs[ov.rows]
    assert (ov.rows == np.flatnonzero(degs > D_HUB)).all()
    assert (lanes > heavy.WARP_LANES).any() == (ov.hubs.shape[0] > 1)
    oracle = int(degs.max()) <= 1100
    # lp_move: labels from the case, one crowded so that moves happen
    W = 60
    nl = int(lab.max()) + 2
    cw = rng.integers(0, 2 * W, nl).astype(np.int32)
    bud = rng.integers(W // 2, 2 * W, nl).astype(np.int32)
    own = rng.integers(0, nl, R).astype(np.int32)
    vw = rng.integers(1, 4, R).astype(np.int32)
    if tied is not None:
        cw[list(tied)] = 3
        bud[list(tied)] = W
        own[1] = nl - 1                              # not a neighbour label
    if case == "no_target":
        row0 = adj[indptr[0]:indptr[1]]
        cw[lab[row0]] = W + 10
        bud[lab[row0]] = -2**20
        own[0] = nl - 1
    salt = int(rng.integers(0, 2**32))
    moved, tgt = lp_split_against_whole(R, indptr, adj, w, lab, cw, own, vw,
                                        W, salt, jax_oracle=oracle)
    lp_split_against_whole(R, indptr, adj, w, lab, cw, own, vw, W, salt,
                           nbud_of=bud, jax_oracle=oracle)
    if tied is not None:
        assert int(tgt[1]) in tied and moved[1]
    if case == "no_target":
        assert not moved[0]
    # bal_scores: the ids index the chunk's rows; blocks from the case
    K = SPLIT_CASES[case][1]
    ids = adj % R
    labels = rng.integers(0, K, R).astype(np.int32)
    labels[rng.random(R) < 0.3] = 0
    if tied is not None:         # row 1: blocks K - 1 and K - 2 tied
        a = int(indptr[1])
        ids[a:a + 600] = rng.integers(2, 20, 600)
        ids[a:a + 100], ids[a + 400:a + 500] = 20, 21
        labels[2:20] = rng.permutation(np.arange(1, K - 2))[:18]
        labels[[20, 21]] = (K - 1, K - 2)
        labels[1] = 0
    vw_b = rng.integers(1, 4, R).astype(np.int32)
    bw = np.bincount(labels, weights=vw_b, minlength=K).astype(np.int32)
    lm = (bw + rng.integers(-3, 6, K)).astype(np.int32)
    if tied is not None:
        bw[[K - 1, K - 2]], lm[[K - 1, K - 2]] = 5, 1000
        bw[0], lm[0] = 10**6, 10
    if case == "no_target":
        lm[labels[ids[indptr[0]:indptr[1]]]] = -10
        labels[0] = labels[ids[indptr[0]]]
    fb = rng.integers(0, K, K).astype(np.int32)
    par = rng.integers(0, max(1, K // 4), K).astype(np.int32)
    for parent in (None, par):
        rel, tgt = bal_split_against_whole(R, indptr, ids, w, labels, vw_b,
                                           bw, lm, fb, parent, salt, R - 2,
                                           jax_oracle=oracle)
        if tied is not None and parent is None:
            assert int(tgt[1]) in (K - 1, K - 2)
        if case == "no_target":
            assert int(tgt[0]) == fb[labels[0]]



def test_slab_width_rule():
    """No overflow where the degrees stay within a warp (rgg2d); ba's hubs
    overflow, and slab plus overflow stay within max(32 rows, 2 m) + m
    lanes."""
    _, h = graphs("rgg2d", 3000)
    mc = move_ops.build_move_chunks(h, 4)
    assert mc.shape[2] == 32 and not mc.has_overflow
    _, h = graphs("ba", 4000)
    mc = move_ops.build_move_chunks(h, 4)
    B, R, D = mc.shape
    assert D == 32 and mc.has_overflow
    slab, over = mc.nbytes
    lanes = max(32 * B * R, 2 * h.m) + h.m
    assert slab + over <= 8 * lanes + 4 * (2 * h.n + B)
    idx, w, ov = bal_ops.build_balance_ell(h, mc.n_pad)
    assert idx.shape == (mc.n_pad + 1, 32) and ov is not None
    deg = np.diff(h.indptr)
    assert int(ov.ptr[-1]) == int(np.maximum(deg - 32, 0).sum())


@pytest.mark.parametrize("family", ["ba", "rhg"])
def test_hub_graph_fused_matches_reference(small_slab, family):
    g, h = graphs(family, 4000)
    mc = move_ops.build_move_chunks(h, 4)
    assert mc.shape[2] == 8 and mc.has_overflow
    W = max(1, g.total_vweight // 200)
    want = ref_coarsening.cluster(g, W, num_iterations=3, num_chunks=4,
                                  seed=5, kernel="composed")
    got = coarsening.cluster(h, W, num_iterations=3, num_chunks=4, seed=5,
                             kernel="fused", device=CPU)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(3)
    k = 8
    part = np.where(rng.random(g.n) < 0.5, 0, rng.integers(0, k, g.n))
    lmax = np.full(k, int(g.total_vweight / k * 1.03) + 1, dtype=np.int64)
    parent = np.arange(k) // 2
    for par in (None, parent):
        want = ref_balance.rebalance(g, part, lmax, parent=par, seed=2,
                                     kernel="composed")
        got = balance.rebalance(h, part, lmax, parent=par, seed=2,
                                kernel="fused", device=CPU)
        np.testing.assert_array_equal(got, want)
    ref = ref_api.Partitioner(backend="single").run(ref_api.PartitionRequest(
        graph=g, k=16, epsilon=0.03, config=CFG, kernel="composed"))
    cfg = carry.config_from_dict(dataclasses.asdict(CFG))
    launches = dict(_build.LAUNCHES)
    res = api.Partitioner(backend="single", device="cpu").run(
        api.PartitionRequest(graph=h, k=16, epsilon=0.03, config=cfg,
                             kernel="fused"))
    np.testing.assert_array_equal(res.assignment, ref.assignment)
    assert res.metrics == ref.metrics and res.feasible == ref.feasible

    def strip(trace):
        return [{k: v for k, v in r.items() if k != "time_s"}
                for r in trace]
    assert strip(res.trace) == strip(ref.trace)
    assert _build.LAUNCHES == launches          # CPU: plain versions only


def test_ell_too_large_is_raised_before_the_build(monkeypatch):
    _, h = graphs("ba", 4000)
    mc = move_ops.build_move_chunks(h, 4)
    monkeypatch.setattr(dispatch, "HOST_ELL_LIMIT_BYTES", 100_000)
    with pytest.raises(dispatch.EllTooLarge) as ei:
        move_ops.build_move_chunks(h, 4)
    msg = str(ei.value)
    assert str(tuple(mc.shape)) in msg and "100000" in msg
    assert isinstance(ei.value, RuntimeError)
    with pytest.raises(dispatch.EllTooLarge):
        coarsening.cluster(h, 50, kernel="fused", device=CPU)
    with pytest.raises(dispatch.EllTooLarge):
        bal_ops.build_balance_ell(h, mc.n_pad)
    with pytest.raises(dispatch.EllTooLarge):
        api.Partitioner(device="cpu").run(api.PartitionRequest(
            graph=h, k=4, kernel="fused"))
    # the composed path builds no ELL form: no limit applies
    res = api.Partitioner(device="cpu").run(api.PartitionRequest(
        graph=h, k=4, kernel="composed", preset="fast"))
    assert res.feasible


def test_stacked_group_serves_a_hub_request_solo():
    """A request whose level-0 ELL chunks overflow leaves the stack and
    runs its iterations solo, on the same kernels: every entry equals its
    solo ``cluster``."""
    specs = [("rgg2d", 500, 1), ("ba", 600, 2), ("rgg2d", 700, 4)]
    hs = [graphs(f, n, s)[1] for f, n, s in specs]
    cfg = carry.config_from_dict(dataclasses.asdict(
        dataclasses.replace(CFG, contraction_limit=128)))
    plans = [level0_cluster_plan(h, 4, cfg) for h in hs]
    assert all(p is not None for p in plans)
    chunks = [coarsening.cluster_prepare(h, p["num_chunks"], p["seed"],
                                         kernel="fused")[2]
              for h, p in zip(hs, plans)]
    assert [c.has_overflow for c in chunks] == [False, True, False]
    got = batching.stacked_level0_labels(hs, plans, device=CPU,
                                         kernel="fused")
    for h, p, lab in zip(hs, plans, got):
        solo = coarsening.cluster(h, p["W"], num_iterations=p[
            "num_iterations"], num_chunks=p["num_chunks"], seed=p["seed"],
            kernel="fused", device=CPU)
        np.testing.assert_array_equal(lab, solo)
