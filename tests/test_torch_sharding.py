"""The port's sharding rules (``repro_torch.dist.sharding``) against the
JAX package's, and the sharding context the sessions and servers hand
to the model layers.

The reference's ``resolve_axes`` and ``ShardCtx.data_groups`` read only
a mesh's ``axis_names`` and ``devices.shape``, so one duck-typed mesh (a
numpy array of that shape standing for the devices) serves both
packages without forcing JAX devices. The grid covers 1-, 2- and 3-axis
meshes of sizes 1-16, every logical axis of ``DEFAULT_RULES`` (and one
that no rule names) and rules with multi-axis targets.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.models import dlrm as ref_dlrm  # noqa: E402
from repro.models.gnn import dimenet as ref_dimenet  # noqa: E402
from repro.models.gnn import gat as ref_gat  # noqa: E402
from repro.models.gnn import nequip as ref_nequip  # noqa: E402
from repro.models.gnn import schnet as ref_schnet  # noqa: E402
from repro_torch import api, carry  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.gnn import gat  # noqa: E402
from repro_torch.serve import PartitionServer  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402
from torch_fake_mesh import fake_mesh  # noqa: E402

CPU = "cpu"
LOGICAL = sorted(sharding.DEFAULT_RULES) + [None, "unnamed"]
NAMES = ("data", "model", "pe", "expert")
MULTI_RULES = dict(sharding.DEFAULT_RULES, batch=("data", "model"),
                   nodes=("pe", "data"), mlp=("model", "expert"),
                   vocab="pe", embed="data")
REF_MODELS = {"gat-cora": ref_gat, "schnet": ref_schnet,
              "nequip": ref_nequip, "dimenet": ref_dimenet,
              "dlrm-rm2": ref_dlrm}


def duck_mesh(names, sizes):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.empty(tuple(sizes), dtype=object))


def meshes():
    rng = np.random.default_rng(0)
    out = []
    for ndim in (1, 2, 3):
        for names in itertools.permutations(NAMES, ndim):
            for _ in range(3):
                out.append(duck_mesh(names, rng.integers(1, 17, ndim)))
    out.append(duck_mesh(("data", "model"), (16, 16)))
    out.append(duck_mesh(("pe",), (1,)))
    return out


@pytest.mark.parametrize("rules", ["default", "multi"])
def test_resolve_axes_and_data_groups_equal_the_reference(rules):
    rules = sharding.DEFAULT_RULES if rules == "default" else MULTI_RULES
    rng = np.random.default_rng(1)
    n = 0
    for mesh in meshes():
        for _ in range(40):
            ndim = int(rng.integers(1, 5))
            shape = tuple(int(x) for x in rng.choice(
                [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 96, 128, 1433],
                ndim))
            axes = tuple(LOGICAL[i] for i in
                         rng.integers(0, len(LOGICAL), ndim))
            want = ref_sharding.resolve_axes(shape, axes, mesh, rules)
            got = sharding.resolve_axes(shape, axes, mesh, rules)
            assert got == tuple(want), (shape, axes, mesh.axis_names,
                                        mesh.devices.shape)
            n += 1
        assert sharding.ShardCtx(mesh, rules).data_groups() == \
            ref_sharding.ShardCtx(mesh, rules).data_groups()
    assert n > 3000
    assert sharding.NULL_CTX.data_groups() == \
        ref_sharding.NULL_CTX.data_groups() == 1
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES


def test_spec_shardings_over_every_model_spec_tree():
    """The port's spec tree resolves as the reference resolves each of
    its ``ParamSpec``s, on a v5e-like 16 x 16 data/model mesh (the one
    of the reference's launch layer) and on a pe mesh."""
    from repro_torch import configs
    for mesh in (duck_mesh(("data", "model"), (16, 16)),
                 duck_mesh(("data", "model"), (2, 4)),
                 duck_mesh(("pe",), (8,))):
        for arch, ref_mod in REF_MODELS.items():
            cfg = ref_configs.get(arch).config
            ref_specs = ref_mod.build_specs(cfg)
            specs = carry._model_module(arch).build_specs(
                configs.get(arch).config)
            got = sharding.spec_shardings(specs, mesh)
            assert sorted(got) == sorted(ref_specs)
            for k, s in ref_specs.items():
                assert got[k] == tuple(ref_sharding.resolve_axes(
                    s.shape, s.axes, mesh)), (arch, k)


def test_constrain_is_the_identity_where_nothing_splits():
    x = torch.zeros(16, 8, 4)
    assert sharding.NULL_CTX.constrain(x, "nodes", "heads", None) is x
    for ctx in (sharding.ShardCtx(sharding.MeshShape(("pe",), (4,))),
                sharding.ShardCtx(duck_mesh(("data", "model"), (1, 1))),
                # 3 divides no dim: the reference replicates, too
                sharding.ShardCtx(duck_mesh(("data", "model"), (3, 3)))):
        assert ctx.constrain(x, "nodes", "heads", None) is x
        assert ctx.constrain(x, "batch", "mlp", "vocab") is x
    split = sharding.ShardCtx(duck_mesh(("data", "model"), (2, 4)))
    for axes in (("nodes", None, None), (None, "heads", None)):
        with pytest.raises(NotImplementedError,
                           match="a split needs a DeviceMesh"):
            split.constrain(x, *axes)
    assert split.constrain(x, "feat", "embed", None) is x
    # on a DeviceMesh the split happens: rank 0 keeps its own piece
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        ctx = sharding.ShardCtx(mesh)
        assert ctx.constrain(x, "feat", "embed", None) is x
        y = ctx.constrain(x, "nodes", "heads", None)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.to_local(), x[:8, :2])


def test_a_model_on_a_pe_context_equals_it_without_one():
    """GAT's forward on a ``pe`` mesh's context is the forward on
    ``NULL_CTX``; a data mesh that would split its nodes refuses it."""
    cfg = ref_configs.get("gat-cora").smoke_config
    specs = gat.build_specs(carry.config_of("gat-cora",
                                            dataclasses.asdict(cfg)))
    params = common.init_params(specs, torch.Generator().manual_seed(0),
                                device=CPU)
    rng = np.random.default_rng(2)
    n = 63
    batch = carry.graph_batch_from(dict(
        senders=rng.integers(0, n, 300).astype(np.int32),
        receivers=rng.integers(0, n, 300).astype(np.int32), n_node=n + 1,
        node_feat=rng.standard_normal((n + 1, cfg.d_in)).astype(np.float32)),
        device=CPU)
    pcfg = carry.config_of("gat-cora", dataclasses.asdict(cfg))
    want = gat.forward(params, batch, pcfg)
    got = gat.forward(params, batch, pcfg, sharding.pe_ctx(4))
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError,
                       match="a split needs a DeviceMesh"):
        gat.forward(params, batch, pcfg, sharding.ShardCtx(
            duck_mesh(("data",), (2,))))
    # on a DeviceMesh the same split runs: its nodes are laid out over
    # the data ranks (a fake group: shapes and layouts, not values)
    with fake_mesh((2,), ("data",)) as mesh, implicit_replication():
        out = gat.forward(params, batch, pcfg, sharding.ShardCtx(mesh))
        assert isinstance(out, DTensor) and out.shape == want.shape


def test_server_shard_ctx_spawns_nothing():
    """A server's context: ``NULL_CTX`` for single-device meshes, else
    a pe axis of ``devices_per_mesh`` PEs, read off the server's count
    (no mesh is touched)."""
    with PartitionServer(device=CPU, meshes=1) as server:
        assert server.shard_ctx is sharding.NULL_CTX
        assert server.workers[0].shard_ctx is sharding.NULL_CTX
    stub = types.SimpleNamespace(devices_per_mesh=3)
    ctx = PartitionServer.shard_ctx.fget(stub)
    assert isinstance(ctx.mesh, sharding.MeshShape)
    assert ctx.mesh == sharding.MeshShape(("pe",), (3,))
    assert ctx.data_groups() == 1
    x = torch.ones(6, 3)
    assert ctx.constrain(x, "nodes", "mlp") is x


def test_pe_mesh_reads_as_a_one_axis_mesh():
    from repro_torch.api.runtime import PeMesh
    stub = types.SimpleNamespace(size=4)
    assert PeMesh.axis_names == ("pe",)
    assert PeMesh.axis_sizes.fget(stub) == (4,)
    assert api.PartitionSession.shard_ctx.fget(types.SimpleNamespace(
        devices=1, _mesh=None)) is sharding.NULL_CTX
