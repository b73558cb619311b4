"""The plain versions that decide ``correct``, held to the program's own
plain (CPU) path at small sizes, and their arithmetic checked by hand."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import graphs, roofline
from bench.reference import check, initial, plain, refine_lp

CPU = torch.device("cpu")


def hand_graph():
    """Two triangles {0,1,2} and {3,4,5} joined by the edge 2-3, one arc
    of weight 2 (1-2)."""
    src = np.array([0, 0, 1, 3, 3, 4, 2])
    dst = np.array([1, 2, 2, 4, 5, 5, 3])
    indptr, adj, w, vw = graphs.from_pairs(6, src, dst)
    w = w.copy()
    a = np.flatnonzero((plain.arc_tails(indptr) == 1) & (adj == 2))
    b = np.flatnonzero((plain.arc_tails(indptr) == 2) & (adj == 1))
    w[a] = w[b] = 2
    return indptr, adj, w, vw


def test_answer_arithmetic():
    g = hand_graph()
    # L_max = max(floor(1.03 * 6 / 2), ceil(6 / 2) + 1) = 4
    assert check.l_max(6, 2, 0.03, 1) == 4
    ok = np.array([0, 0, 0, 1, 1, 1])
    assert check.edge_cut(g[0], g[1], g[2], ok) == 1
    assert check.answer(g, ok, 2, 0.03, 1) == {"ids": 0, "overload": 0,
                                               "cut_gap": 0}
    # edges 0-1, 1-2 (weight 2), 3-5, 4-5 and 2-3 cut: 6; a report of 3
    # is 3 off
    split = np.array([0, 1, 0, 1, 1, 0])
    assert check.edge_cut(g[0], g[1], g[2], split) == 1 + 2 + 1 + 1 + 1
    assert check.answer(g, split, 2, 0.03, 3)["cut_gap"] == 3
    heavy = np.array([0, 0, 0, 0, 0, 1])
    assert check.answer(g, heavy, 2, 0.03, 1)["overload"] == 1
    assert check.answer(g, np.array([0, 0, 0, 1, 1, 2]), 2, 0.03, 1)[
        "ids"] == 1
    assert check.answer(g, ok[:5], 2, 0.03, 1)["ids"] == 6


def test_roofline_counts():
    # a chunk of 4 vertices with 10 arcs: 12 bytes an arc, 16 a vertex
    assert roofline.lp_move(4, 10) == (12 * 10 + 16 * 4, 20)
    # 100 vertices, 7 of them in overloaded blocks with 30 arcs
    assert roofline.bal_scores(100, 7, 30) == (400 + 240 + 84, 60)
    assert roofline.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)


def port_graph(family, n, seed):
    """The benchmark's graph as the program's ``Graph``."""
    from repro_torch.graphs.format import Graph
    cfg = {"family": family, "n": n, "avg_deg": 8, "gamma": 3.0}
    return Graph(*graphs.make(cfg, seed))


GRAPHS = [("rgg2d", 3000, 11), ("rhg", 2500, 12)]


@pytest.mark.parametrize("family,n,seed", GRAPHS)
def test_generators_match_the_programs(family, n, seed):
    """rgg2d is the program's graph; rhg, at the program's own radius, is
    its all-pairs threshold model, which the band sweep must find pair for
    pair."""
    from repro_torch.graphs import generators
    if family == "rgg2d":
        mine = port_graph(family, n, seed)
    else:
        from repro_torch.graphs.format import Graph
        mine = Graph(*graphs.rhg(n, 8, 3.0, seed,
                                 radius=2.0 * np.log(n) - np.log(8)))
    theirs = generators.make(family, n, 8, seed=seed)
    for a in ("indptr", "adjncy", "eweights", "vweights"):
        assert np.array_equal(getattr(mine, a), getattr(theirs, a))


def all_pairs(r, theta, R):
    dt = np.abs(theta[:, None] - theta[None, :])
    dt = np.minimum(dt, 2.0 * np.pi - dt)
    near = np.cosh(r)[:, None] * np.cosh(r)[None, :] \
        - np.sinh(r)[:, None] * np.sinh(r)[None, :] * np.cos(dt) \
        <= np.cosh(R)
    u, v = np.nonzero(np.triu(near, 1))
    return set(zip(u.tolist(), v.tolist()))


@pytest.mark.parametrize("gamma,seed", [(3.0, 1), (2.6, 2), (3.0, 2**33)])
def test_rhg_bands_find_every_pair(gamma, seed):
    n, alpha = 3000, (gamma - 1.0) / 2.0
    R = graphs.rhg_radius(n, 8, gamma)
    rng = np.random.default_rng(seed)
    r = np.arccosh(1.0 + rng.random(n) * (np.cosh(alpha * R) - 1.0)) / alpha
    theta = rng.random(n) * 2.0 * np.pi
    u, v = graphs._rhg_pairs(r, theta, R)
    assert set(zip(u.tolist(), v.tolist())) == all_pairs(r, theta, R)


@pytest.mark.parametrize("seed", [3, 2147483648])
def test_rhg_degree_at_the_cell_size(seed):
    """At the cell's 2^17 vertices the realised average degree is the
    stated 8 (seed to seed it moves with the hubs)."""
    cfg = json.loads((Path(__file__).parent / "configs"
                      / "rhg-n17-k16.json").read_text())
    indptr, adjncy, _, _ = graphs.make(cfg, seed)
    n = indptr.shape[0] - 1
    assert n == 2**17
    assert 7.8 <= adjncy.shape[0] / n <= 8.2
    assert np.diff(indptr).max() > 300          # hubs


def test_rhg_mean_degree_is_the_stated_one():
    """Over seeds the realised average degree is the stated 8: the radius
    is set from the model's expected degree, not from its asymptote."""
    cfg = {"family": "rhg", "n": 2**15, "avg_deg": 8, "gamma": 3.0}
    degs = [graphs.make(cfg, s)[1].shape[0] / 2**15 for s in range(16)]
    assert abs(np.mean(degs) - 8.0) < 0.1


@pytest.mark.parametrize("family,n,seed", GRAPHS)
def test_cluster_and_contract(family, n, seed):
    from repro_torch.core import coarsening, contraction
    g = port_graph(family, n, seed)
    W = 40
    theirs = coarsening.cluster(g, W, 3, 8, seed, kernel="composed",
                                device="cpu")
    assert np.array_equal(plain.cluster(g, W, 3, 8, seed, CPU), theirs)
    assert not np.array_equal(
        plain.cluster(g, W, 3, 8, seed, CPU, full_ties=False), theirs)
    gc, mapping = contraction.contract(g, theirs, kernel="composed",
                                       device="cpu")
    mine, my_mapping = plain.contract(g, theirs)
    assert np.array_equal(my_mapping, mapping)
    for a in ("indptr", "adjncy", "eweights", "vweights"):
        assert np.array_equal(getattr(mine, a), getattr(gc, a))


@pytest.mark.parametrize("family,n,seed", GRAPHS)
def test_balance_and_refine(family, n, seed):
    from repro_torch.core import balance, refinement
    g = port_graph(family, n, seed)
    k = 8
    rng = np.random.default_rng(seed)
    part = rng.integers(0, k, g.n)
    part[: g.n // 3] = 0                      # block 0 far over budget
    lv = np.full(k, check.l_max(g.n, k, 0.03, 1), dtype=np.int64)
    rounds = []
    mine = plain.rebalance(g, part, lv, seed=seed, dev=CPU,
                           rounds_out=rounds)
    assert np.array_equal(mine, balance.rebalance(
        g, part, lv, seed=seed, kernel="composed", device="cpu"))
    assert rounds and rounds[0][0] >= g.n // 3
    assert np.array_equal(
        refine_lp.balance_and_refine(g, part, lv, None, 2, 8, seed, CPU),
        refinement.balance_and_refine(g, part, lv, num_iterations=2,
                                      num_chunks=8, seed=seed,
                                      kernel="composed", device="cpu"))


@pytest.mark.parametrize("family,n,seed", GRAPHS)
def test_initial_partition_and_bisection(family, n, seed):
    """The frozen host stages draw and decide as the program's do."""
    from repro_torch.core import deep_mgp, initial_partition as ip
    g = port_graph(family, n, seed)
    lf = check.l_max(g.n, 16, 0.03, 1)
    counts = ip.distribute_counts(16, 2)
    assert initial.distribute_counts(16, 2) == counts
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    mine = initial.partition_into_counts(plain.CSR.of(g), [3, 5], lf, a, 3)
    assert np.array_equal(mine, ip.partition_into_counts(g, [3, 5], lf, b,
                                                         3))
    assert a.random() == b.random()          # the same draws consumed
    part = np.random.default_rng(seed).integers(0, 4, g.n)
    sub, ids = initial.block_subgraphs(plain.CSR.of(g), part, 4)
    their_sub, their_ids = deep_mgp.extract_block_subgraphs(g, part, 4)
    for s1, s2, i1, i2 in zip(sub, their_sub, ids, their_ids):
        assert np.array_equal(i1, i2)
        for x in ("indptr", "adjncy", "eweights", "vweights"):
            assert np.array_equal(getattr(s1, x), getattr(s2, x))


@pytest.mark.parametrize("family,n,seed", [("rgg2d", 9000, 5),
                                           ("rhg", 7000, 6)])
def test_replay_matches_the_program(family, n, seed):
    """A whole request replayed from the graph alone gives the program's
    answer and every stage result, in the program's call order."""
    from bench.capture import Recorder
    from bench.stages import single as table
    from repro_torch.core import deep_mgp
    from repro_torch.core.partitioner import fast_config
    g = port_graph(family, n, seed)
    rec = Recorder(table.STAGES, tracing=False)
    rec.sampled = True
    try:
        theirs = deep_mgp.partition(
            g, 16, fast_config(seed=seed + 1, kernel="composed"),
            device="cpu")
    finally:
        rec.restore()
    params = dict(k=16, epsilon=0.03, preset="fast", seed=seed + 1)
    mine, stages = check.replay("single", [g.indptr, g.adjncy, g.eweights,
                                           g.vweights], params, CPU)
    assert np.array_equal(mine, theirs)
    kinds = [k for k, *_ in table.STAGES]
    assert {k for k, _ in stages} == set(kinds)
    counts = check.stages(kinds, rec.records, stages)
    assert counts == dict({f"{k}_diff": 0 for k in kinds}, stage_order=0)
    assert check.stages(kinds, rec.records, stages[:-1])["stage_order"] == 1


def test_device_timeline():
    """The traced run's arithmetic: busy time is the union of device
    operations, idle gaps are its complement in the window, each gap is
    named by the innermost host span open at its middle, and a kernel's
    family is found by its ``__global__`` name."""
    from pathlib import Path
    from bench import devtrace
    E = devtrace.DeviceEvent
    ev = [E("a", 1.0, 2.0, 7, "kernel"), E("b", 1.5, 3.0, 7, "kernel"),
          E("c", 5.0, 6.0, 7, "gpu_memcpy")]
    assert devtrace.busy_seconds(ev) == pytest.approx(3.0)
    assert devtrace.idle_gaps(ev, 0.0, 8.0) == [(0.0, 1.0), (3.0, 5.0),
                                                (6.0, 8.0)]
    spans = [("request", 0.0, 7.0), ("host_prep", 3.5, 4.5),
             ("contract", 6.5, 6.9)]
    starts, names = devtrace.innermost(spans)
    at = {t: names[np.searchsorted(starts, t, side="right") - 1]
          for t in (0.5, 4.0, 4.75, 6.7, 6.95, 7.5)}
    assert at == {0.5: "request", 4.0: "host_prep", 4.75: "request",
                  6.7: "contract", 6.95: "request", 7.5: None}
    families = devtrace.kernel_families(Path(devtrace.__file__).parent)
    name = ("void (anonymous namespace)::bal_scores_heavy_rows<true>"
            "(int const*, int*)")
    k = [E(name, 0, 1, 7, "kernel"), E("lp_move_rows(int)", 0, 1, 7,
                                         "kernel"),
         E("at::native::index_kernel", 0, 1, 7, "kernel")]
    devtrace.label(k, families)
    assert [e.family for e in k] == [("bal_round", "bal_scores_heavy_rows"),
                                     ("lp_move", "lp_move_rows"), None]
    assert devtrace.launch_mismatches(k, families, {
        "bal_scores_heavy": 1, "lp_move": 0}) == []
    assert ("bal_scores_heavy_rows", 1, 2) in devtrace.launch_mismatches(
        k, families, {"bal_scores_heavy": 2})


@pytest.mark.parametrize("lost", [None, "start", "end"])
def test_marker_alignment(lost):
    """The window's ends and the host clock's map come from the marker
    kernels, and survive the profiler losing one of the two."""
    from bench import devtrace

    def k(name, ts, stream=7):
        return {"name": name, "ts": ts, "dur": 10, "cat": "kernel",
                "args": {"stream": stream}}
    start, end = k("spin_kernel", 1000.0), k("spin_kernel", 2001000.0)
    dev = [start, k("spin_kernel", 1050.0, stream=9)] \
        + [k("work", 5000.0 + 1000 * i) for i in range(100)] + [end]
    dev = [e for e in dev if e is not {"start": start, "end": end}.get(lost)]
    d0, d1, host, spins, bench = devtrace.align(dev, 10.0, 12.0)
    assert (d0, d1) == (1000.0, 2001000.0)
    assert host(1000.0) == pytest.approx(10.0)
    assert host(1001000.0) == pytest.approx(11.0)
    assert bench == {9}
    assert len(spins) == (3 if lost is None else 2)
    with pytest.raises(RuntimeError, match="marker"):
        devtrace.align([e for e in dev if "spin" not in e["name"]], 10., 12.)
