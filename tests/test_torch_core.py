"""repro_torch's core functions against the JAX package's, bit for bit.

Each test builds one input from a numpy seed, hands it to both packages
(the graph through ``repro_torch.carry.graph_from_arrays``) and compares
the integer results exactly: the LP clustering and refinement chunk loops,
the fused clustering iteration (plain versions of the kernel on the CPU),
the exact balancer (composed and fused), contraction, the host initial
partitioner and the per-level ``balance_and_refine`` (both refinement
tiers).
"""
import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import balance as ref_balance  # noqa: E402
from repro.core import coarsening as ref_coarsening  # noqa: E402
from repro.core import contraction as ref_contraction  # noqa: E402
from repro.core import initial_partition as ref_ip  # noqa: E402
from repro.core import lp as ref_lp  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import refinement as ref_refinement  # noqa: E402
from repro.graphs import format as ref_format  # noqa: E402
from repro.graphs import generators as ref_generators  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import balance, coarsening, contraction  # noqa: E402
from repro_torch.core import initial_partition, lp, refinement  # noqa: E402
from repro_torch.graphs import format as graph_format  # noqa: E402
from repro_torch.graphs import generators  # noqa: E402
from repro_torch.kernels.lp_move import ops as move_ops  # noqa: E402

CPU = torch.device("cpu")


def graphs(family="rgg2d", n=600, seed=11):
    """The same graph in both packages (reference generator, carried)."""
    g = ref_generators.make(family, n, 8.0, seed=seed)
    return g, carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                      g.vweights)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("family,n", [("rgg2d", 600), ("ba", 500)])
def test_port_generators_match_reference(family, n):
    g = ref_generators.make(family, n, 8.0, seed=3)
    h = generators.make(family, n, 8.0, seed=3)
    for name in ("indptr", "adjncy", "eweights", "vweights"):
        np.testing.assert_array_equal(getattr(h, name), getattr(g, name))


def test_weighted_variant_matches_reference():
    g = ref_generators.make("rgg2d", 700, 8.0, seed=4)
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    want = ref_generators.weighted_variant(g, seed=9)
    got = generators.weighted_variant(h, seed=9)
    for name in ("indptr", "adjncy", "eweights", "vweights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.eweights.max() > 1 and got.vweights.max() > 1


@pytest.mark.parametrize("family,n", [("rgg2d", 4000), ("ba", 3000),
                                      ("weighted", 2500)])
def test_permute_and_from_coo_match_reference(family, n):
    """The port's permute (one stable int64-key argsort, bincount degrees)
    and from_coo (bincount degrees) against the reference's (lexsort,
    np.add.at), bit for bit, under seeded random permutations."""
    g = ref_generators.make("rgg2d" if family == "weighted" else family, n,
                            8.0, seed=6)
    if family == "weighted":
        g = ref_generators.weighted_variant(g, seed=6)
    h = carry.graph_from_arrays(g.indptr, g.adjncy, g.eweights, g.vweights)
    rng = np.random.default_rng(n)
    names = ("indptr", "adjncy", "eweights", "vweights")
    for _ in range(3):
        perm = rng.permutation(g.n)
        want, want_inv = ref_format.permute(g, perm)
        got, got_inv = graph_format.permute(h, perm)
        np.testing.assert_array_equal(got_inv, want_inv)
        for name in names:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    src, dst = g.arc_tails(), np.asarray(g.adjncy)
    half = src < dst
    for sym, dedup, (s_, d_) in ((True, True, (src[half], dst[half])),
                                 (False, False, (src, dst)),
                                 (False, True, (dst, src))):
        w = g.eweights[half] if sym else g.eweights
        want = ref_format.from_coo(g.n, s_, d_, eweights=w,
                                   vweights=g.vweights, symmetrize=sym,
                                   dedup=dedup)
        got = graph_format.from_coo(g.n, s_, d_, eweights=w,
                                    vweights=g.vweights, symmetrize=sym,
                                    dedup=dedup)
        for name in names:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _cluster_state(g, num_chunks=4):
    chunks = ref_lp.build_chunks(g, num_chunks)
    n_pad = chunks.n_pad
    vw = np.zeros(n_pad + 1, np.int32)
    vw[:g.n] = g.vweights
    return chunks, n_pad, np.arange(n_pad + 1, dtype=np.int32), vw


@pytest.mark.parametrize("seed,W", [(1, 6), (2, 20), (3, 3)])
def test_cluster_iteration_matches_reference(seed, W):
    g, h = graphs(seed=seed)
    chunks, n_pad, labels, vw = _cluster_state(g)
    h_chunks = lp.build_chunks(h, 4)
    for a, b in ((h_chunks.src, chunks.src), (h_chunks.dst, chunks.dst),
                 (h_chunks.w, chunks.w)):
        np.testing.assert_array_equal(a, b)
    jl, jc = jnp.asarray(labels), jnp.asarray(vw)
    tl, tc = t(labels), t(vw.copy())
    for it in range(3):
        salt = (seed * 1000003 + it) % 2**32
        jl, jc = ref_lp.cluster_iteration(
            jl, jc, jnp.asarray(chunks.src), jnp.asarray(chunks.dst),
            jnp.asarray(chunks.w), jnp.asarray(vw), jnp.int32(W),
            jnp.uint32(salt), n=n_pad)
        tl, tc = lp.cluster_iteration(tl, tc, t(chunks.src), t(chunks.dst),
                                      t(chunks.w), t(vw), W, salt, n=n_pad)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tl.numpy()[:g.n] != np.arange(g.n)).any()    # labels moved


@pytest.mark.parametrize("family,seed,W", [("rgg2d", 4, 8), ("ba", 5, 30)])
def test_fused_cluster_iteration_matches_composed_reference(family, seed, W):
    """The ELL chunk step (the kernel's plain version on the CPU) walks
    the same vertex ranges with the same salts as the composed path."""
    g, h = graphs(family, 500, seed)
    chunks, n_pad, labels, vw = _cluster_state(g)
    mc = move_ops.build_move_chunks(h, 4)
    assert mc.n_pad == n_pad and mc.shape[2] % move_ops.LANE == 0
    # ba's hubs outgrow the capped slab: their further arcs overflow
    assert mc.has_overflow == (family == "ba")
    ov = [None if o is None else tuple(t(x) for x in o)
          for o in mc.overflow]
    jl, jc = jnp.asarray(labels), jnp.asarray(vw)
    tl, tc = t(labels), t(vw.copy())
    for it in range(2):
        jl, jc = ref_lp.cluster_iteration(
            jl, jc, jnp.asarray(chunks.src), jnp.asarray(chunks.dst),
            jnp.asarray(chunks.w), jnp.asarray(vw), jnp.int32(W),
            jnp.uint32(it + 7), n=n_pad)
        tl, tc = move_ops.cluster_iteration_fused(
            tl, tc, t(mc.idx), t(mc.w), mc.v0, t(vw), W, it + 7, n=n_pad,
            overflow=ov)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("kernel", ["composed", "fused"])
def test_cluster_matches_reference(kernel):
    g, h = graphs(seed=6)
    W = max(1, g.total_vweight // 40)
    want = ref_coarsening.cluster(g, W, num_iterations=3, num_chunks=4,
                                  seed=5, kernel="composed")
    got = coarsening.cluster(h, W, num_iterations=3, num_chunks=4, seed=5,
                             kernel=kernel, device=CPU)
    np.testing.assert_array_equal(got, want)


def _refine_inputs(g, k, seed, restricted):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, k, g.n)
    l_final = ref_metrics.l_max(g.total_vweight, k, 0.1,
                                int(g.vweights.max()))
    lv = np.full(k, l_final, dtype=np.int64)
    parent = (np.arange(k) // 2).astype(np.int64) if restricted else None
    return part, lv, parent


@pytest.mark.parametrize("restricted", [False, True])
def test_refine_iteration_matches_reference(restricted):
    g, _ = graphs(seed=8)
    k = 6
    part, lv, parent = _refine_inputs(g, k, 8, restricted)
    chunks = ref_lp.build_chunks(g, 4)
    n_pad = chunks.n_pad
    labels = np.zeros(n_pad + 1, np.int32)
    labels[:g.n] = part
    vw = np.zeros(n_pad + 1, np.int32)
    vw[:g.n] = g.vweights
    bw, lvp, prp, _ = ref_refinement.pad_blocks(
        ref_metrics.block_weights(g, part, k), lv, parent)
    h_pad = refinement.pad_blocks(ref_metrics.block_weights(g, part, k),
                                  lv, parent)
    for a, b in zip(h_pad[:3], (bw, lvp, prp)):
        np.testing.assert_array_equal(a, b)
    jl, jb = jnp.asarray(labels), jnp.asarray(bw)
    tl, tb = t(labels), t(bw)
    for it in range(2):
        seed = (77 * 2654435761 + it) % 2**32
        jl, jb = ref_lp.refine_iteration(
            jl, jb, jnp.asarray(lvp), jnp.asarray(prp),
            jnp.asarray(chunks.src), jnp.asarray(chunks.dst),
            jnp.asarray(chunks.w), jnp.asarray(vw), jnp.uint32(seed),
            n=n_pad, restricted=restricted)
        tl, tb = lp.refine_iteration(
            tl, tb, t(lvp), t(prp), t(chunks.src), t(chunks.dst),
            t(chunks.w), t(vw), seed, n=n_pad, restricted=restricted)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tl.numpy()[:g.n] != part).any()


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("restricted", [False, True])
def test_rebalance_infeasible_partition_matches_reference(kernel,
                                                          restricted):
    """Skewed start (70% in block 0) so the round loop really runs."""
    g, h = graphs(seed=11)
    k = 6
    rng = np.random.default_rng(5)
    part0 = np.where(rng.random(g.n) < 0.7, 0,
                     rng.integers(0, k, g.n)).astype(np.int64)
    l_final = ref_metrics.l_max(g.total_vweight, k, 0.03,
                                int(g.vweights.max()))
    lv = np.full(k, l_final, dtype=np.int64)
    parent = None
    if restricted:        # siblings share a parent; block 0's sibling
        parent = np.array([0, 0, 0, 1, 1, 2])
        lv = lv * np.array([3, 3, 3, 1, 1, 1]) // 2
    st_r, st_t = {}, {}
    want = ref_balance.rebalance(g, part0.copy(), lv, parent=parent, seed=7,
                                 kernel="composed", stats=st_r)
    got = balance.rebalance(h, part0.copy(), lv, parent=parent, seed=7,
                            kernel=kernel, stats=st_t, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert st_t["rounds"] == st_r["rounds"] > 1


@pytest.mark.parametrize("kernel", ["composed", "fused"])
def test_rebalance_beyond_4096_blocks_matches_reference(kernel):
    """k = 5000 (block tables padded to 8192): the fused round keeps its
    kernels at any block count; nothing falls back."""
    g, h = graphs(n=6000, seed=19)
    k = 5000
    part0 = np.arange(g.n, dtype=np.int64) % k
    part0[:300] = 0                           # block 0 far over its budget
    l_final = ref_metrics.l_max(g.total_vweight, k, 0.03,
                                int(g.vweights.max()))
    lv = np.full(k, l_final, dtype=np.int64)
    st_r, st_t = {}, {}
    want = ref_balance.rebalance(g, part0.copy(), lv, seed=3,
                                 kernel="composed", stats=st_r)
    got = balance.rebalance(h, part0.copy(), lv, seed=3, kernel=kernel,
                            stats=st_t, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert st_t["rounds"] == st_r["rounds"] > 1


@pytest.mark.parametrize("kernel", ["composed", "fused"])
@pytest.mark.parametrize("family,style", [("rgg2d", "coarse"),
                                          ("ba", "sparse_ids")])
def test_contract_matches_reference(kernel, family, style):
    g, h = graphs(family, 500, 13)
    rng = np.random.default_rng(7)
    if style == "coarse":
        labels = rng.integers(0, g.n // 8, g.n)
    else:
        labels = rng.choice(10 * g.n, g.n // 5, replace=False)[
            rng.integers(0, g.n // 5, g.n)]
    gc, cl = ref_contraction.contract(g, labels, kernel="composed")
    hc, hl = contraction.contract(h, labels, kernel=kernel, device=CPU)
    np.testing.assert_array_equal(hl, cl)
    for name in ("indptr", "adjncy", "eweights", "vweights"):
        np.testing.assert_array_equal(getattr(hc, name), getattr(gc, name))


@pytest.mark.parametrize("counts", [[1, 1], [8, 8], [3, 2, 2]])
def test_initial_partition_matches_reference(counts):
    g, h = graphs("rgg2d", 300, 21)
    l_final = ref_metrics.l_max(g.total_vweight, sum(counts), 0.03,
                                int(g.vweights.max()))
    want = ref_ip.partition_into_counts(g, counts, l_final,
                                        np.random.default_rng(3), 2)
    got = initial_partition.partition_into_counts(
        h, counts, l_final, np.random.default_rng(3), 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("restricted", [False, True])
def test_balance_and_refine_matches_reference(restricted):
    g, h = graphs(seed=15)
    k = 4
    part, lv, parent = _refine_inputs(g, k, 15, restricted)
    want = ref_refinement.balance_and_refine(g, part, lv, parent=parent,
                                             num_iterations=2, num_chunks=4,
                                             seed=9, kernel="composed")
    for kernel in ("composed", "fused"):
        got = refinement.balance_and_refine(h, part, lv, parent=parent,
                                            num_iterations=2, num_chunks=4,
                                            seed=9, kernel=kernel,
                                            device=CPU)
        np.testing.assert_array_equal(got, want)


def test_unconstrained_balance_and_refine_matches_reference():
    """The unconstrained tier in its sibling-restricted form, on the
    inputs of the LP test above."""
    g, h = graphs(seed=15)
    k = 4
    part, lv, parent = _refine_inputs(g, k, 15, True)
    st_r, st_t = {}, {}
    want = ref_refinement.balance_and_refine(
        g, part, lv, parent=parent, num_iterations=3, num_chunks=4, seed=9,
        kernel="composed", refine="unconstrained", stats=st_r)
    got = refinement.balance_and_refine(
        h, part, lv, parent=parent, num_iterations=3, num_chunks=4, seed=9,
        kernel="fused", refine="unconstrained", stats=st_t, device=CPU)
    np.testing.assert_array_equal(got, want)
    assert st_t == st_r and st_t["penalty"] == [0.0, 0.3333, 0.6667]
