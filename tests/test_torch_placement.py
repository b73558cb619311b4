"""The port's placement engine (``repro_torch.placement``) against the JAX
package's, on ``tests/test_placement.py``'s inputs, on the CPU.

Every integer field of the three plans is bit-identical (assignment,
cut, the relabelled graph and ``perm``, ``offsets``, the halo and
baseline bytes, ``experts_per_pod``) and the fractions and imbalance
are equal: the partitioner under them is held bit-identical to the
reference's elsewhere, and the rest is host numpy. The port builds a
placement's shards from explicit offsets where the reference swaps a
module global; the shards must be the same, and two placements on two
threads at once must each get their own.
"""
import dataclasses
import threading

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

pytest.importorskip("jax")
pytest.importorskip("torch")

from repro.core.partitioner import PartitionerConfig as RefConfig  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro.graphs.format import permute as ref_permute  # noqa: E402
from repro.placement import dlrm_placement as ref_dlrm  # noqa: E402
from repro.placement import gnn_placement as ref_gnn  # noqa: E402
from repro.placement import moe_placement as ref_moe  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.graphs import distribute  # noqa: E402
from repro_torch.placement import dlrm_placement, gnn_placement, \
    moe_placement  # noqa: E402

CPU = "cpu"
PLACE_CFG = dict(contraction_limit=64, ip_repetitions=2, num_chunks=4)


def shuffled_rgg(n, seed):
    """``test_gnn_placement_cuts_halo``'s input: rgg2d with shuffled ids
    (no locality for the naive contiguous split)."""
    g = ref_generators.make("rgg2d", n, 8.0, seed=seed)
    g, _ = ref_permute(g, np.random.default_rng(0).permutation(g.n))
    return g, carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                      g.vweights)


def assert_graphs_equal(got, want):
    for f in ("indptr", "adjncy", "eweights", "vweights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def assert_gnn_plans_equal(got, want):
    assert_graphs_equal(got.graph, want.graph)
    for f in ("perm", "offsets"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("cut", "halo_bytes", "baseline_halo_bytes"):
        assert getattr(got, f) == getattr(want, f), f


def test_gnn_placement_bit_identical():
    rg, pg = shuffled_rgg(3000, 3)
    want = ref_gnn.plan(rg, 8, config=RefConfig(**PLACE_CFG))
    cfg = carry.config_from_dict(dataclasses.asdict(RefConfig(**PLACE_CFG)))
    got = gnn_placement.plan(pg, 8, config=cfg, device=CPU)
    assert_gnn_plans_equal(got, want)
    assert got.halo_bytes < 0.7 * got.baseline_halo_bytes
    # the default config (fast, seed and epsilon) alike
    rg2, pg2 = shuffled_rgg(1200, 5)
    assert_gnn_plans_equal(gnn_placement.plan(pg2, 4, seed=3, device=CPU),
                           ref_gnn.plan(rg2, 4, seed=3))


def test_shards_at_offsets_equal_the_references_patched_split():
    rg, pg = shuffled_rgg(1500, 7)
    offsets = np.array([0, 10, 400, 400, 1100, 1500], dtype=np.int64)
    want = ref_gnn._shards_with_offsets(rg, offsets)
    got = distribute.shards_at_offsets(pg, offsets)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_gnn_placements_on_two_threads_keep_their_own_offsets():
    """Two placements of different graphs at once: each plan equals its
    solo run (no shared state between the two)."""
    graphs = [shuffled_rgg(900, s)[1] for s in (1, 2)]
    cfg = carry.config_from_dict(dataclasses.asdict(RefConfig(**PLACE_CFG)))
    solo = [gnn_placement.plan(g, k, config=cfg, device=CPU)
            for g, k in zip(graphs, (4, 6))]
    out = [None, None]
    barrier = threading.Barrier(2)

    def run(i, k):
        barrier.wait()
        out[i] = gnn_placement.plan(graphs[i], k, config=cfg, device=CPU)
    threads = [threading.Thread(target=run, args=(i, k))
               for i, k in enumerate((4, 6))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got, want in zip(out, solo):
        assert_gnn_plans_equal(got, want)


def dlrm_sparse(B=512, F=26):
    """``test_dlrm_placement_balanced``'s two clusters of co-firing
    features."""
    rng = np.random.default_rng(1)
    sparse = rng.integers(0, 1000, (B, F, 1))
    off = rng.random((B, 1)) < 0.5
    sparse[:, :13][np.broadcast_to(off[:, :, None], (B, 13, 1))] = -1
    sparse[:, 13:][np.broadcast_to(~off[:, :, None], (B, 13, 1))] = -1
    rows = rng.integers(10_000, 1_000_000, F)
    return sparse, rows


@pytest.mark.parametrize("n_shards,epsilon", [(4, 0.5), (3, 0.1)])
def test_dlrm_placement_bit_identical(n_shards, epsilon):
    sparse, rows = dlrm_sparse()
    want = ref_dlrm.plan(sparse, rows, n_shards=n_shards, epsilon=epsilon)
    got = dlrm_placement.plan(sparse, rows, n_shards=n_shards,
                              epsilon=epsilon, device=CPU)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["assignment"], want["assignment"])
    assert got["assignment"].dtype == want["assignment"].dtype
    for f in ("cut", "imbalance", "feasible"):
        assert got[f] == want[f], f
    assert_graphs_equal(dlrm_placement.cooccurrence_graph(sparse, rows),
                        ref_dlrm.cooccurrence_graph(sparse, rows))


def moe_samples(E, T, k, seed):
    """``test_moe_placement_beats_naive``'s block-structured routing,
    with k experts a token."""
    rng = np.random.default_rng(seed)
    grp = rng.integers(0, 4, T)
    shuf = rng.permutation(E)
    cols = [shuf[grp * (E // 4) + rng.integers(0, E // 4, T)]
            for _ in range(k)]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("E,T,k,pods", [(32, 20000, 2, 4), (32, 3000, 8, 4),
                                        (24, 5000, 2, 3)])
def test_moe_placement_bit_identical(E, T, k, pods):
    samples = moe_samples(E, T, k, seed=2)
    want = ref_moe.plan(samples, E, n_pods=pods)
    got = moe_placement.plan(samples, E, n_pods=pods, device=CPU)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["assignment"], want["assignment"])
    for f in ("cross_pod_fraction", "naive_cross_pod_fraction",
              "experts_per_pod"):
        assert got[f] == want[f], f
    assert got["cross_pod_fraction"] <= got["naive_cross_pod_fraction"]
    assert_graphs_equal(moe_placement.coactivation_graph(samples, E),
                        ref_moe.coactivation_graph(samples, E))
