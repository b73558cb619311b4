"""The dry-run (``repro_torch.launch.dryrun``), the production meshes
(``launch/mesh.py``) and the split layouts' building blocks
(``dist/sharding.py``) on fake process groups.

Tolerances: exact everywhere but one. Argument bytes are the local
shards' sizes from the specs; layouts, local shapes and local values of
a split are rank 0's own piece, bit for bit; flop counts are integers
from ``torch.utils.flop_counter``'s formulas. The exception: a
batch-split step's local flops x 256 against the unsplit step's count,
within 1%: the local batch is 1/256 of the global one, and only ops
whose flops do not scale with the batch could differ (none does here).
That check runs on a (256, 1) mesh: on (32, 8) DLRM's MLP splits over
``model`` and its interaction repeats on each of the 8 ``model`` ranks,
so local x 256 is not the unsplit count there (1.89x for the SMOKE
config), as it is not for the reference's GSPMD program.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest
from torch_threads import child_env, one_thread  # noqa: F401
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from torch_fake_mesh import fake_mesh

from repro_torch.configs import load_all
from repro_torch.dist import sharding
from repro_torch.dist.sharding import MeshShape
from repro_torch.launch import dryrun, mesh as mesh_mod, steps

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = {"arch", "shape", "mesh", "mesh_axes", "n_devices",
        "memory_analysis", "cost_analysis", "collectives", "model_flops",
        "hlo_flops_per_device", "hlo_flops_per_device_corrected",
        "optimizer", "device_memory_bytes", "card_memory_bytes", "fits"}
CELLS = [f"{a}/{s.name}" for a, e in load_all().items() for s in e.shapes]


def _smoke(arch):
    e = load_all()[arch]
    return dataclasses.replace(e, config=e.smoke_config)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = child_env(PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src")] +
        [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
         if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--config", "smoke", "--device", "cpu", "--jobs", "4",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = {}
    for path in glob.glob(str(out / "*.json")):
        with open(path) as f:
            r = json.load(f)
        res[f"{r['arch']}/{r['shape']}"] = r
    return res


def _local_bytes(b, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0

    def one(t, spec):
        nonlocal total
        n = t.numel() * t.element_size()
        for entry in spec:
            for nm in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[nm]
        total += n
    from repro_torch.models.common import map_with_specs
    map_with_specs(one, b.args, b.in_shardings)
    return total


@pytest.mark.parametrize("cell", CELLS)
def test_every_smoke_cell_runs_with_every_key(smoke_run, cell):
    """Each cell's line has the reference's keys and the port's, on the
    (32, 8) mesh; its argument bytes are the local shards' bytes of its
    in-shardings, and ``fits`` is arguments plus temporaries against the
    card."""
    r = smoke_run[cell]
    assert set(r) >= KEYS
    assert r["mesh"] == [32, 8] and r["mesh_axes"] == ["data", "model"]
    assert r["n_devices"] == 256
    mem = r["memory_analysis"]
    arch, shape = cell.split("/")
    pod = MeshShape(("data", "model"), (32, 8))
    b = steps.build_step(_smoke(arch), shape, pod)
    assert mem["argument_size_bytes"] == _local_bytes(b, pod)
    assert r["model_flops"] == b.model_flops and r["optimizer"] == \
        b.opt_name
    assert r["hlo_flops_per_device"] == r["cost_analysis"]["flops"] == \
        r["hlo_flops_per_device_corrected"] > 0
    assert mem["temp_size_bytes"] >= 0 and mem["output_size_bytes"] >= 0
    assert r["device_memory_bytes"] == mem["argument_size_bytes"] + \
        mem["temp_size_bytes"]
    assert r["fits"] == (r["device_memory_bytes"] <=
                         r["card_memory_bytes"])
    for op, ent in r["collectives"].items():
        assert ent["count"] > 0 and ent["bytes"] >= 0, op


def test_a_batch_split_step_does_a_256th_of_the_flops():
    """dlrm-rm2 ``serve_bulk`` on a (256, 1) mesh splits only its batch:
    rank 0's flops x 256 are the unsplit step's within 1%."""
    entry = _smoke("dlrm-rm2")
    b = steps.build_step(entry, "serve_bulk",
                         MeshShape(("data", "model"), (1, 1)))
    with b.fake_mode, FlopCounterMode(display=False) as fc:
        b.fn(*b.args)
    want = fc.get_total_flops()
    with fake_mesh((256, 1), ("data", "model")) as mesh:
        r = dryrun.run_cell(entry, "serve_bulk", mesh, "cpu",
                            verbose=False)
    got = r["cost_analysis"]["flops"] * 256
    assert want > 1e9 and abs(got - want) <= 0.01 * want, (got, want)


def test_a_cell_that_raises_makes_the_run_exit_1(monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    try:
        rc = dryrun.main(["--cell", "dlrm-rm2/serve_p99", "--config",
                          "smoke", "--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rc == 1
    out = capsys.readouterr().out
    assert '"error": "RuntimeError(\'boom\')"' in out


def test_the_meter_counts_rank_0s_work():
    """A (1024, 512) x (512, 256) product split (data, model) = (2, 4):
    rank 0's flops are its own piece's, the gather of the result is one
    all-gather of its bytes, and the arguments are not counted as
    temporaries."""
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        from torch._subclasses.fake_tensor import FakeTensorMode
        fm = FakeTensorMode()
        with fm:
            a = distribute_tensor(torch.empty(1024, 512), mesh,
                                  [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(512, 256), mesh,
                                  [Replicate(), Shard(1)],
                                  src_data_rank=None)
        meter = dryrun.StepMeter((a, w))
        with fm, meter:
            c = a @ w
            d = c.redistribute(mesh, [Shard(0), Replicate()])
        assert meter.flops == 2 * 512 * 512 * 64
        assert meter.collectives["all_gather_into_tensor"]["count"] == 1
        assert meter.collectives["all_gather_into_tensor"]["bytes"] == \
            512 * 256 * 4
        assert meter.new_bytes((c, d)) == 512 * 64 * 4 + 512 * 256 * 4
        assert dryrun.local_bytes((a, w)) == 512 * 512 * 4 + 512 * 64 * 4


def test_production_meshes_lay_the_group_out():
    with fake_mesh((512,), ("all",)):
        pod = mesh_mod.make_production_mesh(device="cpu")
        assert tuple(pod.shape) == (32, 8)
        assert pod.mesh_dim_names == ("data", "model")
        multi = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(multi.shape) == (2, 32, 8)
        assert multi.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh_mod.make_node_mesh("cpu").shape) == (1, 8)
        card = mesh_mod.make_card_mesh("cpu")
        assert tuple(card.shape) == (1, 1)
        assert sharding.ShardCtx(pod).data_groups() == 32
        assert sharding.ShardCtx(multi).data_groups() == 32
    with fake_mesh((8,), ("all",)):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="default process group"):
        mesh_mod.make_card_mesh("cpu")


def test_placements_follow_the_spec():
    with fake_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        assert sharding.placements((None, "model"), mesh) == \
            (Replicate(), Replicate(), Shard(1))
        assert sharding.placements((("pod", "data"), None), mesh) == \
            (Shard(0), Shard(0), Replicate())
        assert sharding.placements((), mesh) == (Replicate(),) * 3


def test_constrain_redistributes_on_a_device_mesh():
    x = torch.arange(16 * 8 * 4, dtype=torch.float32).reshape(16, 8, 4)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        ctx = sharding.ShardCtx(mesh)
        # a replicating spec leaves a plain tensor as it is
        assert ctx.constrain(x, "feat", "embed", None) is x
        y = ctx.constrain(x, "nodes", "heads", None)
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.to_local(), x[:8, :2])
        # already laid out: the same DTensor back
        assert ctx.constrain(y, "nodes", "heads", None) is y
        z = ctx.constrain(y, "nodes", None, None)
        assert tuple(z.placements) == (Shard(0), Replicate())
        assert tuple(z.to_local().shape) == (8, 8, 4)
    shape_only = sharding.ShardCtx(MeshShape(("data", "model"), (2, 4)))
    assert shape_only.constrain(x, "feat", "embed", None) is x
    with pytest.raises(NotImplementedError,
                       match="a split needs a DeviceMesh"):
        shape_only.constrain(x, "nodes", None, None)


@pytest.mark.parametrize("to,keeps", [
    ((16, 8 * 4), (Shard(0), Shard(1))),      # merge: heads dim first
    ((2, 8, 8, 4), (Shard(0), Shard(2))),     # split 16 -> (2, 8) over 2
    ((16 * 8, 4), (Shard(0), Replicate())),   # merge: heads not first
    ((16, 2, 4, 4), (Shard(0), Replicate())), # split 8 -> (2, 4) over 4
    ((16, 4, 2, 4), (Shard(0), Shard(1))),    # split 8 -> (4, 2) over 4
])
def test_reshape_keeps_the_shards_it_can(to, keeps):
    x = torch.arange(16 * 8 * 4, dtype=torch.float32).reshape(16, 8, 4)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        y = distribute_tensor(x, mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        z = sharding.reshape(y, to)
        assert tuple(z.shape) == to
        assert tuple(z.placements) == keeps
        assert torch.equal(sharding.reshape(x, to), x.reshape(to))
