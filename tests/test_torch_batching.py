"""repro_torch's ``serve/batching.py`` and ``PartitionSession.submit_many``
against the JAX package's, on the same requests (carried across with
``repro_torch.carry.request_from_fields``), bit for bit: shape buckets,
fingerprints, graph padding, the LRU graph cache, coalescing, and the
stacked level-0 clustering in both kernel modes, down to the ``lp_move``
kernel's request axis (its plain version here; the ``gpu`` tests hold
the kernel to it on the card).

The stacked tests force ``stack="on"``: ``"auto"`` stacks only on a CUDA
device, and these run on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import PartitionerConfig as RefConfig  # noqa: E402
from repro.core.coarsening import cluster as ref_cluster  # noqa: E402
from repro.core.deep_mgp import level0_cluster_plan as ref_plan  # noqa: E402
from repro.kernels.lp_move import ref as ref_lp_ref  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.core import lp, metrics  # noqa: E402
from repro_torch.core.coarsening import cluster, cluster_prepare  # noqa: E402
from repro_torch.core.deep_mgp import level0_cluster_plan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lp_move import lp_move  # noqa: E402
from repro_torch.kernels.lp_move import ops as move_ops  # noqa: E402
from repro_torch.serve import batching  # noqa: E402

CPU = torch.device("cpu")
REF_CFG = RefConfig(contraction_limit=128, ip_repetitions=2, num_chunks=4)
I32_MAX = 2**31 - 1


def ref_req(n=700, k=4, seed=5, family="rgg2d", backend="single", **kw):
    return ref_api.PartitionRequest(
        graph=ref_api.GraphSpec(family, n, 8.0, seed=seed), k=k,
        config=REF_CFG, backend=backend, **kw)


def port(req):
    """The port's request with the reference request's fields."""
    return carry.request_from_fields(
        {f.name: getattr(req, f.name) for f in dataclasses.fields(req)})


def carried(g):
    return carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                   g.vweights)


def same_results(got, want):
    for r, s in zip(got, want, strict=True):
        np.testing.assert_array_equal(r.assignment, s.assignment)
        assert r.cut == s.cut and r.feasible == s.feasible


# ---------------------------------------------------------------------------
# padding ladder, buckets, fingerprints (pure)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,floor", [(1, 1), (2, 1), (3, 1), (1024, 1),
                                     (1025, 1), (0, 256), (300, 256),
                                     (70000, 1024)])
def test_pad_dim_matches_reference(x, floor):
    assert batching.pad_dim(x, floor) == ref_batching.pad_dim(x, floor)


BUCKET_MIX = [dict(), dict(seed=1), dict(seed=2), dict(k=2), dict(n=1100),
              dict(devices=2), dict(n=50000, devices=4, backend="auto"),
              dict(n=50000, devices=4), dict(n=300, k=7)]


@pytest.mark.parametrize("kw", BUCKET_MIX)
def test_bucket_of_matches_reference(kw):
    r = ref_req(**kw)
    want = ref_batching.bucket_of(r)
    got = batching.bucket_of(port(r))
    assert got == (None if want is None else tuple(want))


def test_bucket_of_groups_same_rung_and_keeps_solo_paths_solo():
    assert batching.bucket_of(port(ref_req(seed=1))) == \
        batching.bucket_of(port(ref_req(seed=2)))
    assert batching.bucket_of(port(ref_req())) == \
        batching.BucketKey(1024, 8192, 4, "single")
    assert batching.bucket_of(port(ref_req(k=2))) != \
        batching.bucket_of(port(ref_req(k=4)))
    assert batching.bucket_of(port(ref_req(devices=2))) is None
    assert api.is_batchable("single") and not api.is_batchable("dist")


def test_request_fingerprint_identity_and_distinct_count():
    a, b = port(ref_req()), port(ref_req())
    assert batching.request_fingerprint(a) == batching.request_fingerprint(b)
    assert batching.request_fingerprint(port(ref_req(seed=1))) != \
        batching.request_fingerprint(port(ref_req(seed=2)))
    # raw Graph payloads key by object identity
    g = api.GraphSpec("rgg2d", 300, 8.0, seed=3).materialize()
    x = api.PartitionRequest(graph=g, k=2, backend="single")
    y = api.PartitionRequest(graph=g, k=2, backend="single")
    z = api.PartitionRequest(
        graph=api.GraphSpec("rgg2d", 300, 8.0, seed=3).materialize(), k=2,
        backend="single")
    assert batching.request_fingerprint(x) == batching.request_fingerprint(y)
    assert batching.request_fingerprint(x) != batching.request_fingerprint(z)
    mix = [ref_req(), ref_req(), ref_req(seed=9), ref_req(k=2)]
    assert batching.distinct_count([port(r) for r in mix]) == \
        ref_batching.distinct_count(mix) == 3


def test_request_from_fields_carries_graph_arrays_and_config():
    g = ref_api.GraphSpec("rgg2d", 400, 8.0, seed=2).materialize()
    r = ref_api.PartitionRequest(graph=g, k=3, config=REF_CFG, seed=4,
                                 quality="best", epsilon=0.05)
    p = port(r)
    np.testing.assert_array_equal(p.graph.adjncy, g.adjncy)
    assert dataclasses.asdict(p.config) == dataclasses.asdict(REF_CFG)
    assert (p.k, p.seed, p.quality, p.epsilon) == (3, 4, "best", 0.05)
    assert port(ref_req()).graph == api.GraphSpec("rgg2d", 700, 8.0, seed=5)


# ---------------------------------------------------------------------------
# graph-level padding is inert
# ---------------------------------------------------------------------------

def test_pad_graph_matches_reference_and_preserves_metrics():
    rg = ref_api.GraphSpec("rgg2d", 500, 8.0, seed=11).materialize()
    g = carried(rg)
    res = api.Partitioner(device=CPU).run(
        port(ref_api.PartitionRequest(graph=rg, k=4, config=REF_CFG,
                                      backend="single")))
    gp, rgp = batching.pad_graph(g, 512), ref_batching.pad_graph(rg, 512)
    for f in ("indptr", "adjncy", "eweights", "vweights"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(rgp, f))
    assert gp.n == 512 and gp.m == g.m and gp.vweights[g.n:].sum() == 0
    ext = np.concatenate([res.assignment,
                          np.arange(512 - g.n, dtype=np.int64) % 4])
    assert metrics.edge_cut(gp, ext) == res.cut
    np.testing.assert_array_equal(metrics.block_weights(gp, ext, 4),
                                  metrics.block_weights(g, res.assignment, 4))
    np.testing.assert_array_equal(batching.remove_padding(ext, g.n),
                                  res.assignment)
    assert batching.pad_graph(g, 500) is g
    with pytest.raises(ValueError):
        batching.pad_graph(g, 400)


# ---------------------------------------------------------------------------
# bounded LRU graph cache
# ---------------------------------------------------------------------------

def test_bucket_cache_lru_matches_reference():
    ops = [("set", "a", 1), ("set", "b", 2), ("get", "a"), ("set", "c", 3),
           ("get", "b"), ("set", "d", 4), ("get", "c"), ("set", "a", 5),
           ("set", "e", 6)]
    caches = [api.BucketCache(maxsize=2), ref_api.BucketCache(maxsize=2)]
    seen = []
    for c in caches:
        out = []
        for op in ops:
            if op[0] == "set":
                c[op[1]] = op[2]
            else:
                out.append(c.get(op[1], "miss"))
        seen.append((out, sorted(c.keys()), c.evictions, len(c)))
    assert seen[0] == seen[1]
    assert seen[0][0] == [1, "miss", 3]


def test_session_cache_bound_rematerializes_correctly():
    reqs = [port(ref_api.PartitionRequest(
        graph=ref_api.GraphSpec("rgg2d", 300 + 100 * i, 8.0, seed=i), k=2,
        config=REF_CFG, backend="single")) for i in range(3)]
    solo = api.Partitioner(device=CPU).run_batch(reqs)
    with api.PartitionSession(devices=1, graph_cache_size=1,
                              device=CPU) as sess:
        out = sess.run_batch(reqs) + sess.run_batch(reqs[::-1])
        assert len(sess._graph_cache) == 1
        assert sess._graph_cache.evictions >= 3
    same_results(out, solo + solo[::-1])


# ---------------------------------------------------------------------------
# the stacked level-0 clustering
# ---------------------------------------------------------------------------

def _graphs(specs):
    ref_graphs = [ref_api.GraphSpec(f, n, 8.0, seed=s).materialize()
                  for f, n, s in specs]
    return ref_graphs, [carried(g) for g in ref_graphs]


# the reference test's graphs, and a group whose ELL rows (R) and lanes
# (D: ba's hubs) differ across requests, with request seeds of their own
GROUPS = {
    "reference": [("rgg2d", 500 + 170 * i, 3 + i) for i in range(3)],
    "ragged": [("rgg2d", 500, 1), ("ba", 600, 2), ("rgg2d", 1100, 4)],
}


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_stacked_level0_labels_match_reference_and_solo(group, kernel):
    ref_graphs, graphs = _graphs(GROUPS[group])
    seeds = [0, 0, 0] if group == "reference" else [3, 0, 7]
    cfgs = [dataclasses.replace(REF_CFG, seed=s) for s in seeds]
    ref_plans = [ref_plan(g, 4, c) for g, c in zip(ref_graphs, cfgs)]
    plans = [level0_cluster_plan(g, 4, carry.config_from_dict(
        dataclasses.asdict(c))) for g, c in zip(graphs, cfgs)]
    assert plans == ref_plans and all(p is not None for p in plans)
    if group == "ragged":     # the group really is ragged
        shapes = {cluster_prepare(g, 4, 0, kernel=kernel)[2].w.shape
                  for g in graphs}
        assert len(shapes) == 3
    want = ref_batching.stacked_level0_labels(ref_graphs, ref_plans)
    got = batching.stacked_level0_labels(graphs, plans, device=CPU,
                                         kernel=kernel)
    for g, rg, p, lab, ref in zip(graphs, ref_graphs, plans, got, want):
        np.testing.assert_array_equal(lab, ref)
        solo = cluster(g, p["W"], num_iterations=p["num_iterations"],
                       num_chunks=p["num_chunks"], seed=p["seed"],
                       kernel=kernel, device=CPU)
        np.testing.assert_array_equal(lab, solo)
    if group == "reference":  # the reference's own check, once
        p = ref_plans[0]
        np.testing.assert_array_equal(
            want[0], ref_cluster(ref_graphs[0], p["W"],
                                 num_iterations=p["num_iterations"],
                                 num_chunks=p["num_chunks"],
                                 seed=p["seed"]))


def test_cluster_iteration_stacked_equals_solo_rows():
    _, graphs = _graphs(GROUPS["ragged"])
    n_pad = 2048
    S = len(graphs)
    chunks = [lp.build_chunks(g, 4) for g in graphs]
    m_pad = max(c.w.shape[1] for c in chunks)
    src = np.full((S, 4, m_pad), n_pad, np.int32)
    dst, w = src.copy(), np.zeros((S, 4, m_pad), np.int32)
    vw = np.zeros((S, n_pad + 1), np.int32)
    for s, (g, c) in enumerate(zip(graphs, chunks)):
        mp = c.w.shape[1]
        src[s, :, :mp] = np.where(c.src == c.n_pad, n_pad, c.src)
        dst[s, :, :mp] = np.where(c.dst == c.n_pad, n_pad, c.dst)
        w[s, :, :mp] = c.w
        vw[s, :g.n] = g.vweights
    t = [torch.from_numpy(x) for x in (src, dst, w, vw)]
    labels = torch.arange(n_pad + 1, dtype=torch.int32).repeat(S, 1)
    Ws, seeds = [5, 9, 3], [7, 2**32 - 1, 12345]
    got_l, got_c = lp.cluster_iteration_stacked(labels, t[3].clone(), *t,
                                                Ws, seeds, n=n_pad)
    for s in range(S):
        want_l, want_c = lp.cluster_iteration(
            labels[s], t[3][s].clone(), t[0][s], t[1][s], t[2][s], t[3][s],
            Ws[s], seeds[s], n=n_pad)
        assert torch.equal(got_l[s], want_l) and torch.equal(got_c[s], want_c)
        assert not torch.equal(want_l, labels[s])        # something moved


def _fused_group(graphs, seeds):
    """The stacked fused operands of ``graphs`` at seeds ``seeds`` and
    each graph's solo chunks: (labels, cw, idx, w, v0, vw, n_pad, solo)."""
    solo = [cluster_prepare(g, 4, s, kernel="fused") for g, s in
            zip(graphs, seeds)]
    chunks = [c for _, _, c in solo]
    n_pad = max(c.n_pad for c in chunks)
    R = max(c.idx.shape[1] for c in chunks)
    D = max(c.idx.shape[2] for c in chunks)
    S = len(graphs)
    idx = np.full((4, S, R, D), -1, np.int32)
    w = np.zeros((4, S, R, D), np.int32)
    vw = np.zeros((S, n_pad + 1), np.int32)
    for s, ((_, g2, c)) in enumerate(solo):
        _, r, d = c.idx.shape
        idx[:, s, :r, :d], w[:, s, :r, :d] = c.idx, c.w
        vw[s, :g2.n] = g2.vweights
    v0 = np.stack([c.v0 for c in chunks], axis=1).astype(np.int32)
    return idx, w, v0, vw, n_pad, solo


def test_fused_stacked_iteration_equals_solo_fused_iterations():
    _, graphs = _graphs(GROUPS["ragged"])
    seeds = [3, 0, 7]
    idx, w, v0, vw, n_pad, solo = _fused_group(graphs, seeds)
    S = len(graphs)
    Ws = np.array([5, 4, 6], np.int32)
    it_seeds = [11, 2**31 + 5, 0]
    salts = np.array([lp.chunk_salts(4, s, 0x85EBCA6B) for s in it_seeds],
                     dtype=np.uint32).T.copy().view(np.int32)
    labels = torch.arange(n_pad + 1, dtype=torch.int32).repeat(S, 1)
    vw_t = torch.from_numpy(vw)
    cw = vw_t.clone()
    before = dict(_build.LAUNCHES)
    got_l, got_c = move_ops.cluster_iteration_fused_stacked(
        labels.clone(), cw, torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(v0), vw_t, torch.from_numpy(Ws),
        torch.from_numpy(salts), n=n_pad)
    assert _build.LAUNCHES == before           # CPU: plain versions only
    for s, (_, g2, c) in enumerate(solo):
        num = c.n_pad + 1
        sl = torch.arange(num, dtype=torch.int32)
        svw = vw_t[s, :num].clone()
        want_l, want_c = move_ops.cluster_iteration_fused(
            sl.clone(), svw.clone(), torch.from_numpy(c.idx),
            torch.from_numpy(c.w), c.v0, svw, int(Ws[s]), it_seeds[s],
            n=c.n_pad)
        assert torch.equal(got_l[s, :num], want_l)
        assert torch.equal(got_c[s, :num], want_c)
        # vertices past the request's own table stay weight-0 singletons
        assert torch.equal(got_l[s, num:],
                           torch.arange(num, n_pad + 1, dtype=torch.int32))
        assert not got_c[s, num:].any()
        assert not torch.equal(want_l, sl)


def _stress_inputs(kind, R, seed):
    """An ``lp_move`` chunk that loads the kernel's phase B, as in
    ``test_torch_kernels.py``: ``one_target`` makes every row a
    candidate to label 0, ``spread`` puts candidates on many of ~2^21
    labels, ``holes`` has -1 lanes anywhere in a row, ``none`` no
    candidate. Returns (nlab, nw, ncw, nbud, own, vw, v0, salt, nl, W)."""
    rng = np.random.default_rng(seed)
    D = {"none": 16, "one_target": 4, "spread": 24, "holes": 40}[kind]
    if kind == "one_target":
        W, nl = 10, R + 1
        nlab = np.full((R, D), -1)
        nlab[:, 0] = 0
        nw = np.where(nlab >= 0, 3, 0)
        ncw = np.where(nlab >= 0, 1, I32_MAX)
        own = 1 + np.arange(R)
        vw = np.full(R, 2)
    else:
        W, nl = {"none": (10**6, 40), "spread": (40, 2**21 - 5),
                 "holes": (30, 50)}[kind]
        pool = rng.choice(nl, min(nl, max(2, R // 4)), replace=False)
        nlab = pool[rng.integers(0, pool.size, (R, D))]
        nlab[rng.random((R, D)) < 0.4] = -1
        nlab[R - R // 8:] = -1
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        lo, hi = (0, 20) if kind == "none" else (W // 2, W - 2)
        ncw = np.where(nlab >= 0, rng.integers(lo, hi, (R, D)), I32_MAX)
        own = pool[rng.integers(0, pool.size, R)]
        vw = rng.integers(1, 4, R)
    nbud = np.minimum(ncw + vw[:, None] + rng.integers(0, 2, (R, D)),
                      I32_MAX)
    v0 = int(rng.integers(0, 1000))
    salt = int(rng.integers(0, 2**32))
    arrs = [x.astype(np.int32) for x in (nlab, nw, ncw, nbud, own, vw)]
    return (*arrs, v0, salt, nl, W)


def _stacked_stress(S, seed=5):
    """S ``lp_move`` chunks that load phase B, each its own R and D,
    padded into one stacked call: (stacked operands, per-request
    operands, num_labels)."""
    kinds = [("one_target", 1500), ("spread", 700), ("holes", 900),
             ("none", 1100), ("holes", 300)]
    reqs = [_stress_inputs(kind, R, seed=seed + s)
            for s, (kind, R) in enumerate(kinds[:S])]
    R = max(r[0].shape[0] for r in reqs)
    D = max(r[0].shape[1] for r in reqs)
    nl = max(r[8] for r in reqs)
    slab = np.full((4, S, R, D), -1, np.int64)
    slab[1:] = 0
    slab[2] = I32_MAX
    rows = np.zeros((2, S, R), np.int64)
    for s, (nlab, nw, ncw, nbud, own, vw, *_rest) in enumerate(reqs):
        r, d = nlab.shape
        for i, x in enumerate((nlab, nw, ncw, nbud)):
            slab[i, s, :r, :d] = x
        rows[0, s, :r], rows[1, s, :r] = own, vw
        rows[0, s, r:] = own[-1]
        rows[1, s, r:] = 1
    scal = [np.array([r[k] for r in reqs], np.int64) for k in (9, 6, 7)]
    scal[2] = scal[2].astype(np.uint32).view(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
         for x in (*slab, *rows, *scal)]
    return t, reqs, nl


@pytest.mark.parametrize("fit_sum", [True, False])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_lp_move_stacked_plain_matches_reference_per_request(S, fit_sum):
    """The stacked call's plain version, request by request, against the
    JAX package's ``lp_move_chunk_ref`` on that request's own unpadded
    chunk: rows past a request's own R (the group's padding) never
    move."""
    t, reqs, nl = _stacked_stress(S)
    nlab, nw, ncw, nbud, own, vw, W, v0, salt = t
    moved, tgt = lp_move.lp_move_chunk_stacked(
        nlab, nw, ncw, own, vw, W, v0, salt, nl,
        nbud=None if fit_sum else nbud)
    for s, (rnlab, rnw, rncw, rnbud, rown, rvw, rv0, rsalt, _, rW) in \
            enumerate(reqs):
        R = rnlab.shape[0]
        jargs = [jnp.asarray(x) for x in (rnlab, rnw, rncw, rown[:, None],
                                          rvw[:, None],
                                          np.array([[rW, rv0]], np.int32))]
        jargs.append(jnp.asarray(np.array([[rsalt]], dtype=np.uint32)))
        r_moved, r_tgt = ref_lp_ref.lp_move_chunk_ref(
            *jargs, None if fit_sum else jnp.asarray(rnbud),
            fit_sum=fit_sum)
        np.testing.assert_array_equal(moved[s, :R].numpy(),
                                      np.asarray(r_moved)[:, 0])
        np.testing.assert_array_equal(tgt[s, :R].numpy(),
                                      np.asarray(r_tgt)[:, 0])
        assert not moved[s, R:].any()
        assert torch.equal(tgt[s, R:], own[s, R:])


def test_stacked_launch_limits_raise():
    lp_move.check_stack_limits(3, 262144, 2**20 + 1)
    for S, R, nl in [(0, 4, 4), (65536, 4, 4), (2, 2**30, 4),
                     (3, 4, 2**30 + 1), (1, 0, 4)]:
        with pytest.raises(ValueError, match="launch limits"):
            lp_move.check_stack_limits(S, R, nl)
    slabs = 2 * 3 * 8 * 262144 * 32 * 4 + 3 * 3 * (2**20 + 1) * 4
    assert move_ops.stacked_bytes(3, 8, 262144, 32, 2**20 + 1) == \
        slabs + 3 * 262144 * (32 * 21 + 64) + 3 * 12 * (2**20 + 1)
    assert move_ops.stacked_bytes(1, 8, 262144, 32, 2**20 + 1) == \
        2 * 8 * 262144 * 32 * 4 + 3 * (2**20 + 1) * 4 + 8 * 262144 * 32 * 4


def test_stacked_wrapper_routes_by_device():
    t, _, nl = _stacked_stress(2)
    nlab, nw, ncw, _, own, vw, W, v0, salt = t
    before = dict(_build.LAUNCHES)
    out = lp_move.lp_move_chunk_stacked(nlab, nw, ncw, own, vw, W, v0, salt,
                                        nl)
    assert all(x.device.type == "cpu" for x in out)
    assert _build.LAUNCHES == before
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        lp_move.lp_move_chunk_stacked(*meta[:3], *meta[4:], nl)


# ---------------------------------------------------------------------------
# coalescing, run_coalesced and submit_many: bit-identity
# ---------------------------------------------------------------------------

def test_stack_knob_resolves_by_device():
    assert not batching.stack_enabled("auto", CPU)
    assert batching.stack_enabled("auto", torch.device("cuda"))
    assert batching.stack_enabled("on", CPU)
    assert not batching.stack_enabled("off", torch.device("cuda"))
    with pytest.raises(ValueError):
        api.PartitionSession(stack="maybe", device=CPU)


def test_coalescing_shares_one_run_matches_reference_and_solo():
    ref_reqs = [ref_req(), ref_req(seed=9), ref_req(), ref_req()]
    reqs = [port(r) for r in ref_reqs]
    solo = api.Partitioner(device=CPU).run_batch(reqs)
    with api.PartitionSession(devices=1, stack="off", device=CPU) as sess:
        out = sess.submit_many(reqs).result()
        served = sess.stats()["served"]
    with ref_api.PartitionSession(devices=1, stack="off") as ref_sess:
        want = ref_sess.submit_many(ref_reqs).result()
    assert out[0] is out[2] and out[0] is out[3] and out[0] is not out[1]
    assert served == 2
    same_results(out, solo)
    same_results(out, want)


@pytest.mark.parametrize("kernel", ["composed", "fused"])
def test_run_coalesced_stacked_matches_reference_and_solo(kernel):
    ref_reqs = [ref_req(n=500, k=2, seed=1), ref_req(n=700, k=4, seed=2),
                ref_req(n=900, k=4, seed=3), ref_req(n=700, k=4, seed=2)]
    reqs = [dataclasses.replace(port(r), kernel=kernel) for r in ref_reqs]
    solo = api.Partitioner(device=CPU).run_batch(reqs)
    with api.PartitionSession(devices=1, stack="on", device=CPU) as sess:
        calls = []
        hints = batching._level0_hints

        def spy(session, requests, stack):
            out = hints(session, requests, stack)
            calls.append(sum(h is not None for h in out))
            return out

        batching._level0_hints = spy
        try:
            out = batching.run_coalesced(sess, reqs, stack="on")
        finally:
            batching._level0_hints = hints
    with ref_api.PartitionSession(devices=1, stack="on") as ref_sess:
        want = ref_batching.run_coalesced(ref_sess, ref_reqs, stack="on")
    assert calls == [3]        # three distinct requests, one stack
    same_results(out, solo)
    same_results(out, want)
    assert all(r.feasible for r in out)


def test_submit_many_matches_reference_session_with_stacking():
    ref_reqs = [ref_req(n=600, k=4, seed=s) for s in (1, 2, 1, 3)]
    ref_reqs.append(ref_req(n=600, k=4, seed=2, quality="best"))
    reqs = [port(r) for r in ref_reqs]
    solo = api.Partitioner(device=CPU).run_batch(reqs)
    with api.PartitionSession(stack="on", device=CPU) as sess:
        out = sess.submit_many(reqs).result()
        assert sess.stats()["served"] == 4
        sess.close()
        with pytest.raises(RuntimeError, match="session is closed"):
            sess.submit_many(reqs)
    with ref_api.PartitionSession(stack="on") as ref_sess:
        want = ref_sess.submit_many(ref_reqs).result()
    same_results(out, solo)
    same_results(out, want)
    assert out[0] is out[2]


# ---------------------------------------------------------------------------
# on the card: the stacked kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fit_sum", [True, False])
@pytest.mark.parametrize("S", [1, 2, 5])
def test_lp_move_stacked_kernel_matches_plain_on_gpu(S, fit_sum,
                                                      cuda_device):
    t, _, nl = _stacked_stress(S)
    nlab, nw, ncw, nbud, own, vw, W, v0, salt = t
    on = [x.to(cuda_device) for x in t]
    before = _build.LAUNCHES["lp_move_stacked"]
    got = lp_move.lp_move_chunk_stacked(
        *on[:3], *on[4:], nl, nbud=None if fit_sum else on[3])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lp_move_stacked"] == before + 1
    want = lp_move.lp_move_chunk_stacked(
        nlab, nw, ncw, own, vw, W, v0, salt, nl,
        nbud=None if fit_sum else nbud)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_stacked_level0_labels_on_gpu_match_solo(cuda_device):
    _, graphs = _graphs(GROUPS["ragged"])
    cfg = carry.config_from_dict(dataclasses.asdict(REF_CFG))
    plans = [level0_cluster_plan(g, 4, cfg) for g in graphs]
    before = _build.LAUNCHES["lp_move_stacked"]
    got = batching.stacked_level0_labels(graphs, plans, kernel="fused")
    assert _build.LAUNCHES["lp_move_stacked"] == \
        before + plans[0]["num_iterations"] * plans[0]["num_chunks"]
    for g, p, lab in zip(graphs, plans, got):
        solo = cluster(g, p["W"], num_iterations=p["num_iterations"],
                       num_chunks=p["num_chunks"], seed=p["seed"],
                       kernel="fused")
        np.testing.assert_array_equal(lab, solo)
