"""The port's models (``repro_torch.models``), configs and GNN batches
against the JAX package on the same numpy inputs, on the CPU.

The reference's parameters come from its own ``init_params`` and cross
over through ``repro_torch.carry.model_from`` (JAX's threefry stream has
no torch counterpart, so equal seeds would not give equal weights);
batches cross through ``carry.graph_batch_from`` / ``dlrm_batch_from``.
The reference's forwards run eagerly, as ``tests/test_arch_smoke.py``
runs them. Tolerances:

* GAT, SchNet and DLRM: rtol = atol = 1e-5 (``tests/test_kernels.py``'s);
* NequIP and DimeNet: 1e-4 (``test_nequip_equivariance``'s): their
  einsum contractions and recurrences run in another order;
* ``retrieval_score``'s top-k ids, ``build_triplets``,
  ``spherical_bessel_roots``, the spec trees, the configs and
  ``build_gnn_batch``'s arrays: equal.
"""
import dataclasses

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import gnn_data as ref_gnn_data  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import dlrm as ref_dlrm  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.gnn import common as ref_gcommon  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import gat as ref_gat  # noqa: E402
from repro.models.gnn import nequip as ref_nequip  # noqa: E402
from repro.models.gnn import schnet as ref_schnet  # noqa: E402
from repro_torch import carry, configs  # noqa: E402
from repro_torch.launch import gnn_data  # noqa: E402
from repro_torch.models import common, dlrm, transformer  # noqa: E402
from repro_torch.models.gnn import common as gcommon  # noqa: E402
from repro_torch.models.gnn import dimenet, gat, nequip, schnet  # noqa: E402

CPU = "cpu"
LMS = list(carry.LM_ARCHS)
ARCHS = ["gat-cora", "schnet", "nequip", "dimenet", "dlrm-rm2"] + LMS
GNNS = ARCHS[:4]
REF = {"gat-cora": ref_gat, "schnet": ref_schnet, "nequip": ref_nequip,
       "dimenet": ref_dimenet, "dlrm-rm2": ref_dlrm,
       **{a: ref_transformer for a in LMS}}
PORT = {"gat-cora": gat, "schnet": schnet, "nequip": nequip,
        "dimenet": dimenet, "dlrm-rm2": dlrm,
        **{a: transformer for a in LMS}}
TOL = {"gat-cora": 1e-5, "schnet": 1e-5, "dlrm-rm2": 1e-5,
       "nequip": 1e-4, "dimenet": 1e-4}
REF_ENTRIES = ref_configs.load_all()


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def carried(arch, cfg, seed=0):
    """The reference's parameters (its own init) and the port's copy."""
    ref_params = ref_common.init_params(REF[arch].build_specs(cfg),
                                        jax.random.key(seed))
    arrays = {k: np.asarray(v) for k, v in ref_params.items()}
    params, pcfg = carry.model_from(arch, arrays, dataclasses.asdict(cfg),
                                    device=CPU)
    return ref_params, params, pcfg


def both_batches(fields):
    """A reference ``GraphBatch`` and the port's from the same numpy
    fields."""
    ref = ref_gcommon.GraphBatch(**{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in fields.items()})
    return ref, carry.graph_batch_from(fields, device=CPU)


def mol_fields(rng, n=24, e=64, n_graphs=2, want_trip=False,
               n_species=10):
    """``test_arch_smoke._mol_batch``'s batch as numpy fields."""
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n, e)
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    snd, rcv = np.concatenate([snd, rcv]), np.concatenate([rcv, snd])
    E = snd.shape[0]
    pos = rng.standard_normal((n + 1, 3)).astype(np.float32) * 1.5
    gid = (np.arange(n + 1) * n_graphs // (n + 1)).astype(np.int32)
    f = dict(senders=snd.astype(np.int32), receivers=rcv.astype(np.int32),
             n_node=n + 1, species=rng.integers(0, n_species, n + 1),
             positions=pos, graph_id=gid, n_graphs=n_graphs,
             labels=rng.standard_normal(n_graphs).astype(np.float32),
             node_mask=np.arange(n + 1) < n)
    if want_trip:
        kj, ji = ref_dimenet.build_triplets(f["senders"], f["receivers"],
                                            n + 1, cap=4 * E)
        f.update(trip_kj=kj, trip_ji=ji)
    return f


def bonded_fields(rng, n_graphs, atoms=30, bonds=64):
    """Molecules bonded along their closest pairs (the molecule shape's
    geometry, as ``chip_smoke.py`` phase 12c builds it), with DimeNet's
    triplets."""
    iu, ju = np.triu_indices(atoms, 1)
    pos = rng.standard_normal((n_graphs, atoms, 3)).astype(np.float32) * 1.5
    snd, rcv = [], []
    for gi in range(n_graphs):
        near = np.argsort(np.linalg.norm(pos[gi][iu] - pos[gi][ju], axis=-1),
                          kind="stable")[:bonds]
        a, b = iu[near] + gi * atoms, ju[near] + gi * atoms
        snd += [a, b]
        rcv += [b, a]
    n = n_graphs * atoms
    f = dict(senders=np.concatenate(snd).astype(np.int32),
             receivers=np.concatenate(rcv).astype(np.int32), n_node=n + 1,
             species=rng.integers(1, 10, n + 1),
             positions=np.concatenate([pos.reshape(n, 3),
                                       np.zeros((1, 3), np.float32)]),
             graph_id=np.minimum(np.arange(n + 1) // atoms,
                                 n_graphs - 1).astype(np.int32),
             n_graphs=n_graphs, node_mask=np.arange(n + 1) < n)
    E = f["senders"].size
    kj, ji = ref_dimenet.build_triplets(f["senders"], f["receivers"], n + 1,
                                        16 * E)
    f.update(trip_kj=kj, trip_ji=ji)
    return f


def gat_fields(rng, cfg, n=60, e=200):
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    # a few sentinel (padding) edges, as from_graph pads
    snd = np.concatenate([snd, np.full(5, n, np.int32)])
    rcv = np.concatenate([rcv, np.full(5, n, np.int32)])
    return dict(senders=snd, receivers=rcv, n_node=n + 1,
                node_feat=rng.standard_normal((n + 1, cfg.d_in))
                .astype(np.float32),
                labels=rng.integers(0, cfg.n_classes, n + 1),
                node_mask=np.arange(n + 1) < n)


@pytest.mark.parametrize("arch", GNNS)
def test_gnn_forward_and_loss_match_reference(arch):
    cfg = REF_ENTRIES[arch].smoke_config
    rng = np.random.default_rng(3)
    fields = gat_fields(rng, cfg) if arch == "gat-cora" else \
        mol_fields(rng, want_trip=(arch == "dimenet"))
    rb, pb = both_batches(fields)
    ref_params, params, pcfg = carried(arch, cfg)
    want = REF[arch].forward(ref_params, rb, cfg)
    got = PORT[arch].forward(params, pb, pcfg)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.float32
    close(got, want, TOL[arch])
    close(PORT[arch].loss_fn(params, pb, pcfg),
          REF[arch].loss_fn(ref_params, rb, cfg), TOL[arch])


@pytest.mark.parametrize("arch", GNNS)
def test_build_gnn_batch_matches_reference(arch):
    """``launch/gnn_data.build_gnn_batch``: the same arrays from the same
    seed (triplets included)."""
    cfg = REF_ENTRIES[arch].smoke_config
    rb = ref_gnn_data.build_gnn_batch(arch, cfg, n=150, seed=4)
    pb = gnn_data.build_gnn_batch(arch, cfg, n=150, seed=4, device=CPU)
    for f in dataclasses.fields(rb):
        a, b = getattr(rb, f.name), getattr(pb, f.name)
        if isinstance(a, int) or a is None:
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)


def test_from_graph_matches_reference():
    """``gnn.common.from_graph``: the same padded arrays and positions
    from the same graph and seed."""
    from repro.graphs import generators as ref_generators
    rg = ref_generators.make("rgg2d", 300, 8.0, seed=6)
    pg = carry.graph_from_arrays(rg.indptr, rg.adjncy, rg.eweights,
                                 rg.vweights)
    feat = np.random.default_rng(6).standard_normal((301, 5)).astype(
        np.float32)
    rb = ref_gcommon.from_graph(rg, feat=feat, labels=np.arange(301),
                                seed=9, with_positions=True, pad_edges=7)
    pb = gcommon.from_graph(pg, feat=feat, labels=np.arange(301), seed=9,
                            with_positions=True, pad_edges=7, device=CPU)
    for f in dataclasses.fields(rb):
        a, b = getattr(rb, f.name), getattr(pb, f.name)
        if isinstance(a, int) or a is None:
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f.name)


def dlrm_fields(rng, cfg, B=48, bag=3):
    sparse = rng.integers(0, cfg.vocab_per_table, (B, cfg.n_sparse, bag))
    # jnp.take counts an index in [-V, 0) from the end of the table
    sparse[rng.random(sparse.shape) < 0.1] = -1
    sparse[0, 0, 0] = -cfg.vocab_per_table
    return dict(dense=rng.standard_normal((B, cfg.n_dense))
                .astype(np.float32),
                sparse=sparse.astype(np.int32),
                labels=rng.integers(0, 2, B).astype(np.float32))


def test_dlrm_forward_and_loss_match_reference():
    cfg = REF_ENTRIES["dlrm-rm2"].smoke_config
    fields = dlrm_fields(np.random.default_rng(8), cfg)
    ref_params, params, pcfg = carried("dlrm-rm2", cfg)
    rb = {k: jnp.asarray(v) for k, v in fields.items()}
    pb = carry.dlrm_batch_from(fields, device=CPU)
    got = dlrm.forward(params, pb, pcfg)
    assert tuple(got.shape) == (fields["dense"].shape[0],)
    close(got, ref_dlrm.forward(ref_params, rb, cfg), TOL["dlrm-rm2"])
    close(dlrm.loss_fn(params, pb, pcfg),
          ref_dlrm.loss_fn(ref_params, rb, cfg), TOL["dlrm-rm2"])
    # the standalone bag, sum and mean, weighted
    tab = np.asarray(ref_params["tables"][1])
    idx = fields["sparse"][:, 1]
    w = np.random.default_rng(9).random(idx.shape).astype(np.float32)
    for mode in ("sum", "mean"):
        close(dlrm.embedding_bag(torch.from_numpy(tab), torch.from_numpy(idx),
                                 torch.from_numpy(w), mode=mode),
              ref_dlrm.embedding_bag(jnp.asarray(tab), jnp.asarray(idx),
                                     jnp.asarray(w), mode=mode), 1e-5)


def test_dlrm_indices_outside_the_table_raise_on_the_host():
    """The reference fills such a row with NaN; the port refuses it."""
    cfg = REF_ENTRIES["dlrm-rm2"].smoke_config
    fields = dlrm_fields(np.random.default_rng(8), cfg, B=4)
    _, params, pcfg = carried("dlrm-rm2", cfg)
    for bad in (cfg.vocab_per_table, -cfg.vocab_per_table - 1):
        f = dict(fields, sparse=fields["sparse"].copy())
        f["sparse"][2, 3, 1] = bad
        with pytest.raises(ValueError, match="must lie in"):
            dlrm.forward(params, carry.dlrm_batch_from(f, device=CPU), pcfg)


def test_dlrm_retrieval_top_k_ids_equal():
    cfg = REF_ENTRIES["dlrm-rm2"].smoke_config
    rng = np.random.default_rng(11)
    fields = dlrm_fields(rng, cfg, B=1)
    fields["candidates"] = rng.standard_normal(
        (5000, cfg.embed_dim)).astype(np.float32)
    ref_params, params, pcfg = carried("dlrm-rm2", cfg, seed=5)
    rb = {k: jnp.asarray(v) for k, v in fields.items()}
    wv, wi = ref_dlrm.retrieval_score(ref_params, rb, cfg, top_k=64)
    gv, gi = dlrm.retrieval_score(params, carry.dlrm_batch_from(
        fields, device=CPU), pcfg, top_k=64)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gv, wv, 1e-5)
    # exact ties rank by the lower index, as lax.top_k ranks them
    ties = np.random.default_rng(1).integers(-3, 4, 4000).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(ties), 300)
    np.testing.assert_array_equal(
        dlrm.largest(torch.from_numpy(ties), 300)[1].numpy(),
        np.asarray(want))


def test_nequip_rotation_invariance():
    """The port's energy is invariant under a global rotation, at the
    reference test's 1e-4."""
    from scipy.spatial.transform import Rotation
    cfg = REF_ENTRIES["nequip"].smoke_config
    fields = mol_fields(np.random.default_rng(5))
    _, params, pcfg = carried("nequip", cfg, seed=1)
    _, b1 = both_batches(fields)
    R = Rotation.random(random_state=7).as_matrix().astype(np.float32)
    b2 = dataclasses.replace(b1,
                             positions=b1.positions @ torch.from_numpy(R).T)
    close(nequip.forward(params, b2, pcfg), nequip.forward(params, b1, pcfg),
          1e-4)


@pytest.mark.parametrize("l1,l2", [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1),
                                   (2, 2)])
def test_nequip_cartesian_products_match_reference(l1, l2):
    rng = np.random.default_rng(10 * l1 + l2)
    a = rng.standard_normal((7, 4) + (3,) * l1).astype(np.float32)
    b = rng.standard_normal((7, 4) + (3,) * l2).astype(np.float32)
    want = ref_nequip.cart_tp(l1, jnp.asarray(a), l2, jnp.asarray(b))
    got = nequip.cart_tp(l1, torch.from_numpy(a), l2, torch.from_numpy(b))
    assert sorted(got) == sorted(want)
    for lo in want:
        close(got[lo], want[lo], 1e-5)
    t = rng.standard_normal((5, 3, 3)).astype(np.float32)
    close(nequip.sym_traceless(torch.from_numpy(t)),
          ref_nequip.sym_traceless(jnp.asarray(t)), 1e-6)
    np.testing.assert_array_equal(nequip._EPS.numpy(),
                                  np.asarray(ref_nequip._EPS))
    assert nequip.PATHS == ref_nequip.PATHS


def test_dimenet_host_helpers_bit_identical():
    rng = np.random.default_rng(12)
    for n, e in ((30, 90), (200, 900)):
        f = mol_fields(rng, n=n, e=e)
        for cap in (10, 8 * e):
            want = ref_dimenet.build_triplets(f["senders"], f["receivers"],
                                              n + 1, cap)
            got = dimenet.build_triplets(f["senders"], f["receivers"],
                                         n + 1, cap)
            for g_, w_ in zip(got, want):
                assert g_.dtype == w_.dtype
                np.testing.assert_array_equal(g_, w_)
    for n_l, n_r in ((4, 4), (7, 6)):
        np.testing.assert_array_equal(
            dimenet.spherical_bessel_roots(n_l, n_r),
            ref_dimenet.spherical_bessel_roots(n_l, n_r))
    # the upward recurrence loses every digit for x below l (both
    # packages alike: an ulp of sin or cos grows by ~(2l+1)/x a step),
    # so the two are held where it is well conditioned
    x = jnp.asarray(rng.uniform(3.0, 20.0, (300,)).astype(np.float32))
    c = jnp.asarray(rng.uniform(-1.0, 1.0, (300,)).astype(np.float32))
    for l_max in range(7):
        close(dimenet.spherical_jn(l_max, torch.from_numpy(np.array(x))),
              ref_dimenet.spherical_jn_jax(l_max, x), 1e-5)
        close(dimenet.legendre(l_max, torch.from_numpy(np.array(c))),
              ref_dimenet.legendre_jax(l_max, c), 1e-5)


def ref_spec_leaves(specs, path=()):
    """The reference spec tree's ``(path, spec)`` pairs, keys sorted."""
    if ref_common.is_spec(specs):
        return [(path, specs)]
    return [leaf for k in sorted(specs)
            for leaf in ref_spec_leaves(specs[k], path + (k,))]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_spec_trees_and_param_count_equal(arch):
    """Every leaf of the nested spec trees (the LMs' ``layers/*`` too):
    its path, shape, axes, init, scale and dtype."""
    for which in ("config", "smoke_config"):
        rcfg = getattr(REF_ENTRIES[arch], which)
        pcfg = getattr(configs.get(arch), which)
        ref_specs = REF[arch].build_specs(rcfg)
        specs = PORT[arch].build_specs(pcfg)
        assert common.param_count(specs) == \
            ref_common.param_count(ref_specs)
        want = ref_spec_leaves(ref_specs)
        got = common.spec_leaves(specs)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, s), (_, rs) in zip(got, want):
            assert (s.shape, s.axes, s.init, s.scale) == \
                (rs.shape, rs.axes, rs.init, rs.scale), path
            assert s.dtype == carry.torch_dtype(rs.dtype), path
    if arch in LMS:
        for batch, max_len, lc in ((8, 32768, False), (1, 524288, True)):
            want = ref_transformer.cache_specs(rcfg, batch, max_len, lc)
            got = transformer.cache_specs(pcfg, batch, max_len, lc)
            for n in ("k", "v"):
                assert (got[n].shape, got[n].axes, got[n].init) == \
                    (want[n].shape, want[n].axes, want[n].init)
                assert got[n].dtype == carry.torch_dtype(want[n].dtype)


def test_lm_param_counts_equal_the_reference_and_its_bands():
    """The reference's ``test_param_counts_match_assignment`` bands, and
    the port's counts equal to the reference's."""
    bands = {"arctic-480b": (4.0e11, 5.5e11),
             "granite-moe-1b-a400m": (0.8e9, 1.6e9),
             "gemma-2b": (2.0e9, 3.3e9), "stablelm-12b": (1.0e10, 1.45e10),
             "qwen2-7b": (6.0e9, 8.5e9)}
    for arch, (lo, hi) in bands.items():
        count = common.param_count(
            transformer.build_specs(configs.get(arch).config))
        assert count == ref_common.param_count(ref_transformer.build_specs(
            REF_ENTRIES[arch].config))
        assert lo < count < hi, (arch, count)


def test_registry_holds_ten_entries_and_forty_shapes():
    entries = configs.load_all()
    assert set(entries) == set(REF_ENTRIES) == set(ARCHS)
    assert {e.kind for e in entries.values()} == {"lm", "gnn", "recsys"}
    assert sum(len(e.shapes) for e in entries.values()) == 40
    assert sorted(a for a, e in entries.items() if e.kind == "lm") == \
        sorted(LMS)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_entries_keep_the_reference_widths(arch):
    ref, port = REF_ENTRIES[arch], configs.get(arch)
    assert (port.arch_id, port.kind, port.family) == \
        (ref.arch_id, ref.kind, ref.family)
    for which in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(ref, which))
        got = dataclasses.asdict(getattr(port, which))
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(got[k], torch.dtype):
                assert got[k] == carry.torch_dtype(v), k
            else:
                assert got[k] == v, k
        assert carry.config_of(arch, want) == getattr(port, which)
    assert [dataclasses.astuple(s) for s in port.shapes] == \
        [dataclasses.astuple(s) for s in ref.shapes]
    assert [dataclasses.astuple(s) for s in configs.LM_SHAPES] == \
        [dataclasses.astuple(s) for s in ref_configs.LM_SHAPES]
    assert set(configs.load_all()) == set(ARCHS)


def test_bases_and_segment_ops_match_reference():
    rng = np.random.default_rng(13)
    d = rng.uniform(0.05, 12.0, 500).astype(np.float32)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    for num, stop in ((300, 10.0), (24, 5.0), (8, 5.0), (2, 3.0)):
        close(gcommon.linspace(0.0, stop, num),
              jnp.linspace(0.0, stop, num), 1e-6)
    for n_rbf, cutoff in ((300, 10.0), (24, 5.0)):
        close(gcommon.gaussian_rbf(td, n_rbf, cutoff),
              ref_gcommon.gaussian_rbf(jd, n_rbf, cutoff), 1e-5)
    for n_rbf, cutoff in ((8, 5.0), (6, 5.0)):
        close(gcommon.bessel_rbf(td, n_rbf, cutoff),
              ref_gcommon.bessel_rbf(jd, n_rbf, cutoff), 1e-5)
        close(gcommon.cosine_cutoff(td, cutoff),
              ref_gcommon.cosine_cutoff(jd, cutoff), 1e-6)
    # segments 0..9 with every third empty, plus out-of-range ids that
    # segment_sum drops
    seg = rng.integers(0, 10, 400)
    seg = seg[seg % 3 != 0]
    seg[:5] = [-1, 10, 12, -4, 10]
    x = rng.standard_normal((seg.size, 3)).astype(np.float32)
    close(gcommon.scatter_sum(torch.from_numpy(x), torch.from_numpy(seg), 10),
          jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(seg),
                              num_segments=10), 1e-5)
    ok = (seg >= 0) & (seg < 10)
    got = gcommon.segment_max(torch.from_numpy(x[ok]),
                              torch.from_numpy(seg[ok]), 10)
    want = jax.ops.segment_max(jnp.asarray(x[ok]), jnp.asarray(seg[ok]),
                               num_segments=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[0]).all()
    s = rng.standard_normal((seg[ok].size, 2)).astype(np.float32)
    close(gcommon.edge_softmax(torch.from_numpy(s),
                               torch.from_numpy(seg[ok]), 10),
          ref_gcommon.edge_softmax(jnp.asarray(s), jnp.asarray(seg[ok]), 10),
          1e-6)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "silu", "relu", "ssp",
                                  "tanh", "rms_norm", "layer_norm", "rope",
                                  "cross_entropy"])
def test_common_ops_match_reference(name):
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((3, 5, 4, 8)) * 4).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    g = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    if name == "rms_norm":
        got = common.rms_norm(tx, torch.from_numpy(g))
        want = ref_common.rms_norm(jx, jnp.asarray(g))
    elif name == "layer_norm":
        got = common.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
        want = ref_common.layer_norm(jx, jnp.asarray(g), jnp.asarray(b))
    elif name == "rope":
        pos = rng.integers(0, 4096, (3, 5))
        got = common.rope(tx, torch.from_numpy(pos))
        want = ref_common.rope(jx, jnp.asarray(pos))
    elif name == "cross_entropy":
        lab = rng.integers(0, 8, (3, 5, 4))
        mask = (rng.random((3, 5, 4)) < 0.7).astype(np.float32)
        for m in (None, mask):
            close(common.cross_entropy_loss(
                tx, torch.from_numpy(lab),
                None if m is None else torch.from_numpy(m), z_loss=1e-3),
                ref_common.cross_entropy_loss(
                    jx, jnp.asarray(lab),
                    None if m is None else jnp.asarray(m), z_loss=1e-3),
                1e-5)
        return
    else:
        got = common.act_fn(name)(tx)
        want = ref_common.act_fn(name)(jx)
    close(got, want, 1e-5)


def test_init_params_draws_from_the_generator():
    """Zeros and ones as specified, normals of the reference's scale in
    the reference's leaf order, the same draw from the same seed."""
    cfg = configs.get("schnet").smoke_config
    specs = schnet.build_specs(cfg)

    def draw(seed):
        return common.init_params(specs, torch.Generator().manual_seed(seed),
                                  device=CPU)
    a, b, c = draw(0), draw(0), draw(1)
    assert sorted(a) == sorted(specs)
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape and a[k].dtype == s.dtype
        assert torch.equal(a[k], b[k])
        if s.init == "zeros":
            assert not a[k].any() and not c[k].any()
        else:
            assert not torch.equal(a[k], c[k])
    emb = a["embed"]                       # init "embed": std = scale
    assert abs(float(emb.std()) - 1.0) < 0.1
    w = a["i0_fw0"]                        # std = scale / sqrt(fan_in)
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.1
    # leaf i is the i-th draw of the stream, in sorted key order
    gen = torch.Generator().manual_seed(0)
    for _, s in common.spec_leaves(specs):
        if s.init in ("zeros", "ones"):
            continue
        first = torch.randn(s.shape, generator=gen)
    assert torch.equal(first * common._std(s), a["ro_w1"])


def test_init_params_draws_low_precision_leaves_in_slices(monkeypatch):
    """A bf16 leaf with a leading (stack) axis is drawn ``DRAW_CHUNK``
    float32 normals at a time, each slice scaled and rounded into it:
    its spec's shape, dtype and scale, the same leaf from the same seed;
    a float32 leaf is still one draw of its whole shape."""
    monkeypatch.setattr(common, "DRAW_CHUNK", 1000)
    bf16 = torch.bfloat16
    specs = {"a": common.ParamSpec((3, 40, 50), ("stack", "embed", "mlp"),
                                   dtype=bf16),
             "b": common.ParamSpec((40, 30), ("embed", "mlp")),
             "c": common.ParamSpec((7, 64), ("vocab", "embed"),
                                   init="embed", scale=0.02, dtype=bf16)}

    def draw(seed):
        return common.init_params(specs, torch.Generator().manual_seed(seed),
                                  device=CPU)
    a, b, c = draw(0), draw(0), draw(1)
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape and a[k].dtype == s.dtype
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    # std = scale / sqrt(fan_in), fan_in = the leading axis (3)
    assert abs(float(a["a"].float().std()) * np.sqrt(3) - 1.0) < 0.05
    assert abs(float(a["c"].float().std()) / 0.02 - 1.0) < 0.1
    gen = torch.Generator().manual_seed(0)
    want_a = torch.cat([(torch.randn(1000, generator=gen)
                         * common._std(specs["a"])).to(bf16)
                        for _ in range(6)]).reshape(3, 40, 50)
    want_b = torch.randn((40, 30), generator=gen) * common._std(specs["b"])
    want_c = (torch.randn(448, generator=gen) * 0.02).to(bf16)
    assert torch.equal(a["a"], want_a)
    assert torch.equal(a["b"], want_b)
    assert torch.equal(a["c"], want_c.reshape(7, 64))


def test_init_params_frees_its_leaves_with_the_tree():
    """Dropping the tree frees its tensors at once, with the cycle
    collector off: nothing of ``init_params`` holds them in a cycle."""
    import gc
    import weakref
    specs = transformer.build_specs(configs.get("qwen2-7b").smoke_config)
    gc.disable()
    try:
        params = common.init_params(specs, torch.Generator().manual_seed(0),
                                    device=CPU)
        leaf = weakref.ref(params["layers"]["wq"])
        del params
        assert leaf() is None
    finally:
        gc.enable()


def test_dimenet_bessel_recurrence_holds_where_float32_loses_it():
    """The reference's float32 upward recurrence loses j_l below x ~ l
    (a fault of the reference); the port runs it in float64. Against
    scipy's j_l on x in [0.5, 3] (molecules' range at l <= 6): the
    port's error stays at float32's rounding, the reference's does not.
    At the full config the port's energies then stay put under a 1-ulp
    change of every position."""
    from scipy import special
    x = np.linspace(0.5, 3.0, 400).astype(np.float32)
    truth = np.stack([special.spherical_jn(l, x.astype(np.float64))
                      for l in range(7)], axis=-1)
    got = dimenet.spherical_jn(6, torch.from_numpy(x)).double().numpy()
    ref = np.asarray(ref_dimenet.spherical_jn_jax(6, jnp.asarray(x)),
                     dtype=np.float64)
    assert np.abs(got - truth).max() < 1e-6
    assert np.abs(ref - truth).max() > 1e-2
    cfg = configs.get("dimenet").config
    f = bonded_fields(np.random.default_rng(15), n_graphs=4)
    params = common.init_params(dimenet.build_specs(cfg),
                                torch.Generator().manual_seed(3), device=CPU)
    b = carry.graph_batch_from(f, device=CPU)
    up = dataclasses.replace(b, positions=torch.nextafter(
        b.positions, torch.full_like(b.positions, np.inf)))
    close(dimenet.forward(params, up, cfg), dimenet.forward(params, b, cfg),
          1e-4)
