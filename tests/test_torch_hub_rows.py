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
from repro_torch.core import balance, coarsening  # noqa: E402
from repro_torch.core.deep_mgp import level0_cluster_plan  # noqa: E402
from repro_torch.kernels import _build, dispatch  # noqa: E402
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
