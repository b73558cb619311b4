"""The port's distributed engine (``repro_torch.dist``) function by
function against the JAX reference's, run live on forced host devices.

One subprocess runs every reference job of this file and one runs the
port's: a gloo group of P ranks for each P, one process a rank
(``tests/torch_dist_jobs.py``). Each job gets the same graph and inputs in
both packages and must return the same arrays bit for bit:

  * the collectives at P = 2, 4 and 6 (a 2 x 3 grid), direct and grid
    routing, against ``repro.dist.collectives`` under ``shard_map``;
  * ``distribute_graph``;
  * ``dist_cluster``, ``dist_enforce_cluster_weights``, ``dist_contract``,
    ``dist_rebalance``, ``dist_lp_refine`` and ``dist_ulp_refine`` at P = 1
    and 2, in both ``weights`` layouts and (where the function has a
    kernel) both kernel modes. "fused" runs the kernels' plain versions
    on the CPU; the reference runs composed (its Pallas kernels are broken
    on this jax). The ba graph's hubs overflow the capped ELL slab, so the
    fused clustering takes ``lp_move``'s heavy rows in the distributed
    admission form.

Every port job must also return the same bytes on every rank.
"""
import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

pytest.importorskip("jax")
pytest.importorskip("torch")

import torch_dist_jobs  # noqa: E402

RGG = ["rgg2d", 1200, 8.0, 5]
BA = ["ba", 1200, 8.0, 7]


def _jobs():
    jobs = []

    def add(jid, **kw):
        jobs.append(dict(id=jid, **kw))

    for P in (2, 4, 6):
        for grid in (False, True):
            add(f"collectives-P{P}-{'grid' if grid else 'direct'}",
                kind="collectives", P=P, graph=RGG, use_grid=grid)
    for P in (2, 4):
        add(f"distribute-P{P}", kind="distribute", P=P, graph=RGG)
    for P in (1, 2):
        for weights in ("replicated", "owner"):
            for kernel in ("composed", "fused"):
                tag = f"P{P}-{weights}-{kernel}"
                add(f"cluster-{tag}", kind="cluster", P=P, graph=RGG, W=9,
                    weights=weights, kernel=kernel, seed=3)
                add(f"rebalance-{tag}", kind="rebalance", P=P, graph=RGG,
                    k=4, skew=True, seed_in=P, weights=weights,
                    kernel=kernel, seed=11)
            add(f"lp_refine-P{P}-{weights}", kind="lp_refine", P=P,
                graph=RGG, k=4, seed_in=5, weights=weights, seed=2)
            add(f"ulp_refine-P{P}-{weights}", kind="ulp_refine", P=P,
                graph=RGG, k=4, seed_in=6, weights=weights, seed=4)
        for kernel in ("composed", "fused"):
            add(f"contract-P{P}-{kernel}", kind="contract", P=P, graph=RGG,
                kernel=kernel, seed_in=7)
        add(f"enforce-P{P}", kind="enforce", P=P, graph=RGG, W=6,
            cluster_div=50, seed_in=8)
    add("cluster-ba-P2-owner-fused", kind="cluster", P=2, graph=BA, W=40,
        weights="owner", kernel="fused", seed=1)
    add("cluster-ba-P1-replicated-fused", kind="cluster", P=1, graph=BA,
        W=40, weights="replicated", kernel="fused", seed=1)
    add("contract-P2-grid-fused", kind="contract", P=2, graph=BA,
        kernel="fused", seed_in=9, use_grid=True)
    add("enforce-P4-grid", kind="enforce", P=4, graph=RGG, W=6,
        cluster_div=50, seed_in=8, use_grid=True)
    return jobs


JOBS = _jobs()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return torch_dist_jobs.run_both(JOBS, str(tmp_path_factory.mktemp("dj")))


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (where, a.shape, b.shape)
        assert np.array_equal(a.astype(np.int64) if a.dtype == bool else a,
                              b.astype(np.int64) if b.dtype == bool else b), \
            where
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("jid", [j["id"] for j in JOBS])
def test_matches_the_reference(results, jid):
    ref, port = results
    _equal(port[jid], ref[jid], jid)
    assert port[jid + ":same_on_every_rank"]


def test_the_jobs_do_real_work(results):
    """The inputs are not trivial: clustering merges vertices, the
    balancer runs rounds, enforcement ejects, contraction shrinks."""
    _, port = results
    n = RGG[1]
    assert np.unique(port["cluster-P2-owner-fused"]).size < n // 2
    assert port["rebalance-P2-owner-fused"]["stats"]["rounds"] > 1
    assert port["enforce-P2"]["stats"]["ejected"] > 0
    assert port["contract-P2-fused"]["stats"]["nc"] < n
