"""Run the step builders of the JAX reference or of the port (a helper of
``tests/test_torch_steps.py``, run as a script).

    python tests/torch_steps_jobs.py ref  OUT.pkl
    python tests/torch_steps_jobs.py port OUT.pkl

``ref`` forces 512 host devices and, in one process:

* builds every (arch x shape) cell with ``repro.launch.steps.build_step``
  on a (32, 8) ``("data", "model")`` mesh and a (2, 32, 8)
  ``("pod", "data", "model")`` one, recording each cell's name,
  ``opt_name``, ``model_flops`` and every argument leaf's path, shape,
  dtype and ``PartitionSpec`` (as a tuple);
* runs the ``CASES`` (SMOKE configs at float32 compute, small shapes
  whose dims divide a 2 x 2 mesh) through the reference's built ``fn``,
  jitted with its ``in_shardings`` on a 2 x 2 mesh of four of those
  devices.

``port`` spawns four gloo ranks (the CPU, one thread each) on a 2 x 2
``DeviceMesh`` and runs each case's port step on DTensors laid out by its
``in_shardings``; rank 0 also runs the step unsplit (a 1 x 1 mesh of
sizes, plain tensors). Outputs are numpy arrays keyed by their tree
paths, pickled as ``{case: {...}}``.

Both draw the same inputs from numpy (``draw_inputs``), so the two run
at once: each parameter leaf from a generator seeded by its path, at
its spec's init and scale; the port takes them through
``repro_torch.carry`` as it takes any reference tree.
"""
from __future__ import annotations

import os
import pickle
import sys
import zlib

import numpy as np

LM = ("gemma-2b", "granite-moe-1b-a400m")
# (case id, arch, shape name, kind, shape params)
CASES = [(f"{a}/{n}", a, n, k, p) for a in LM for n, k, p in (
    ("train", "train", {"seq_len": 16, "global_batch": 4}),
    ("prefill", "prefill", {"seq_len": 16, "global_batch": 4}),
    ("decode", "decode", {"seq_len": 32, "global_batch": 4}))] + [
    ("gat-cora/train", "gat-cora", "train", "gnn_full",
     {"n_nodes": 60, "n_edges": 200, "n_pad": 64, "e_pad": 256}),
    ("dlrm-rm2/train", "dlrm-rm2", "train", "recsys_train", {"batch": 8}),
    ("dlrm-rm2/serve", "dlrm-rm2", "serve", "recsys_serve", {"batch": 8}),
]
MESH_2X2 = ((2, 2), ("data", "model"))
PROD_MESHES = (((32, 8), ("data", "model")),
               ((2, 32, 8), ("pod", "data", "model")))


def _path(keys) -> str:
    out = []
    for k in keys:
        out.append(str(getattr(k, "key", getattr(k, "idx", k))))
    return "/".join(out)


def _inputs(case, arch, kind, p, cfg, rng):
    """Numpy inputs of a case's non-parameter arguments."""
    if kind in ("train", "prefill"):
        return {"tokens": rng.integers(0, cfg.vocab, (p["global_batch"],
                                                      p["seq_len"]))
                .astype(np.int32)}
    if kind == "decode":
        B, S = p["global_batch"], p["seq_len"]
        lens = np.array([3, 5, 0, 7][:B], dtype=np.int32)
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        live = np.arange(S)[None, :] < lens[:, None]          # (B, S)
        k *= live[None, :, :, None, None]
        v *= live[None, :, :, None, None]
        return {"cache": {"k": k, "v": v},
                "tokens": rng.integers(0, cfg.vocab, B).astype(np.int32),
                "cache_len": lens}
    if kind == "gnn_full":
        n, e, n_pad, e_pad = p["n_nodes"], p["n_edges"], p["n_pad"], \
            p["e_pad"]
        snd = np.full(e_pad, n_pad - 1, np.int32)
        rcv = np.full(e_pad, n_pad - 1, np.int32)
        snd[:e] = rng.integers(0, n, e)
        rcv[:e] = rng.integers(0, n, e)
        mask = np.zeros(n_pad, bool)
        mask[:n] = True
        return {"senders": snd, "receivers": rcv, "node_mask": mask,
                "node_feat": rng.standard_normal((n_pad, 16))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.n_classes, n_pad)
                .astype(np.int32)}
    B = p["batch"]
    out = {"dense": rng.standard_normal((B, cfg.n_dense)).astype(np.float32),
           "sparse": rng.integers(0, cfg.vocab_per_table,
                                  (B, cfg.n_sparse, cfg.bag_size))
           .astype(np.int32)}
    if kind == "recsys_train":
        out["labels"] = rng.integers(0, 2, B).astype(np.float32)
    return out


def draw_params(leaves):
    """Numpy parameters of ``(path, spec)`` leaves: zeros or ones as the
    spec says, else normals of the reference's scale (``embed``: its
    scale; else scale / sqrt(fan-in)), each from a generator seeded by
    its path."""
    out = {}
    for path, spec in leaves:
        shape = tuple(spec.shape)
        if spec.init in ("zeros", "ones"):
            a = (np.zeros if spec.init == "zeros" else np.ones)(shape)
        else:
            fan_in = shape[0] if len(shape) >= 2 else max(1, int(
                np.prod(shape)))
            std = spec.scale if spec.init == "embed" else \
                spec.scale / np.sqrt(fan_in)
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            a = rng.standard_normal(shape) * std
        out[path] = a.astype(np.float32)
    return out


def nest(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for path, v in flat.items():
        d = out
        *head, last = path.split("/")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def draw_inputs(cid, leaves, cfg):
    """A case's parameters (nested dicts of numpy) and other inputs."""
    _, arch, name, kind, p = next(c for c in CASES if c[0] == cid)
    return nest(draw_params(leaves)), _inputs(cid, arch, kind, p, cfg,
                                              np.random.default_rng(7))


def _args(kind, params, opt_init, data):
    """The step's argument tuple from parameters and the numpy inputs."""
    if kind == "decode":
        return (params, data["cache"], data["tokens"], data["cache_len"])
    if kind == "prefill":
        return (params, data["tokens"])
    if kind == "recsys_serve":
        return (params, data)
    state = {"params": params, "opt": opt_init(params),
             "step": np.zeros((), np.int32),
             "nan_skips": np.zeros((), np.int32)}
    return (state, data)


def _ref_main(out_path):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=512")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import ShapeSpec, load_all
    from repro.launch.steps import build_step
    from repro.train.optimizer import OptConfig, make_optimizer

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

    def leaves(tree):
        return jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: x is None)[0]

    registry = load_all()
    meta = {}
    for shape, names in PROD_MESHES:
        mesh = mesh_of(shape, names)
        for entry in registry.values():
            for s in entry.shapes:
                b = build_step(entry, s.name, mesh)
                meta[(shape, b.name)] = {
                    "opt_name": b.opt_name, "model_flops": b.model_flops,
                    "args": {_path(k): (tuple(v.shape), str(v.dtype))
                             for k, v in leaves(b.args)},
                    "shardings": {_path(k): tuple(v.spec)
                                  for k, v in leaves(b.in_shardings)}}
    mesh = mesh_of(*MESH_2X2)
    cases = {}
    for cid, arch, name, kind, p in CASES:
        entry = registry[arch]
        cfg = entry.smoke_config
        if hasattr(cfg, "compute_dtype") and arch in LM:
            cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32)
        entry = dataclasses.replace(entry, config=cfg,
                                    shapes=(ShapeSpec(name, kind, p),))
        b = build_step(entry, name, mesh)
        specs = _specs_of(arch, cfg)
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "axes"))[0]
        params, data = draw_inputs(cid, [(_path(k), v) for k, v in flat],
                                   cfg)
        params = jax.tree_util.tree_map(jnp.asarray, params)
        opt_init = make_optimizer(OptConfig(name=b.opt_name or "adamw",
                                            lr=1e-3))[0]
        args = _args(kind, params, opt_init, data)
        got = jax.jit(b.fn, in_shardings=b.in_shardings)(*args)
        cases[cid] = {"out": {_path(k): np.asarray(v)
                              for k, v in leaves(got)}}
    with open(out_path, "wb") as f:
        pickle.dump({"meta": meta, "cases": cases}, f)


def _specs_of(arch, cfg):
    """The reference's spec tree of a case (GAT's input width is the
    shape's, as ``build_gnn_train`` sets it)."""
    import dataclasses

    from repro.models import dlrm, transformer
    from repro.models.gnn import gat
    if arch == "gat-cora":
        return gat.build_specs(dataclasses.replace(cfg, d_in=16))
    if arch == "dlrm-rm2":
        return dlrm.build_specs(cfg)
    return transformer.build_specs(cfg)


def _case_model(cid):
    """A case's entry (its SMOKE config, float32 compute for the LMs, and
    its one shape), config fields and spec tree."""
    import dataclasses

    import torch

    from repro_torch import carry
    from repro_torch.configs import ShapeSpec, load_all

    _, arch, name, kind, p = next(c for c in CASES if c[0] == cid)
    entry = load_all()[arch]
    cfg = entry.smoke_config
    if arch in LM:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    entry = dataclasses.replace(entry, config=cfg,
                                shapes=(ShapeSpec(name, kind, p),))
    fields = dataclasses.asdict(cfg)
    if arch == "gat-cora":
        fields["d_in"] = 16
    specs = carry._model_module(arch).build_specs(
        carry.config_of(arch, fields))
    return entry, fields, specs


def _port_inputs(cid, mesh):
    """A case's port step on ``mesh`` (``None``: a 1 x 1 mesh of sizes)
    and its inputs: parameters carried from the numpy draw, the rest as
    numpy."""
    from repro_torch import carry
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch.steps import build_step
    from repro_torch.models.common import spec_leaves

    entry, fields, specs = _case_model(cid)
    arch, name = entry.arch_id, entry.shapes[0].name
    b = build_step(entry, name, mesh if mesh is not None
                   else MeshShape(("data", "model"), (1, 1)))
    leaves = [("/".join(path), s) for path, s in spec_leaves(specs)]
    params, data = draw_inputs(cid, leaves, entry.config)
    params, _ = carry.model_from(arch, params, fields, device="cpu")
    return b, params, data


def port_case(cid, mesh):
    """A case's port step on ``mesh`` (a ``DeviceMesh``, or ``None``: the
    unsplit step on plain tensors): ``{path: numpy}`` of its outputs."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import distribute
    from repro_torch.train.tree import leaves_with_paths

    kind = next(c for c in CASES if c[0] == cid)[3]
    b, params, data = _port_inputs(cid, mesh)
    args = _port_args(kind, b, params, data)
    if mesh is not None:
        args = distribute(args, b.in_shardings, mesh)
    out = b.fn(*args)
    res = {}
    for path, v in leaves_with_paths(out):
        if isinstance(v, DTensor):
            v = v.full_tensor()
        res["/".join(path)] = v.detach().numpy()
    return res


def _port_args(kind, b, params, data):
    """The port step's arguments: ``params``, the numpy inputs as tensors
    of the dtypes of the step's fake arguments, and a fresh optimizer
    state (the reference's ``init``, as ``_args`` makes it there)."""
    import torch

    from repro_torch.train.optimizer import OptConfig, make_optimizer

    def like(a, fake):
        return torch.tensor(np.asarray(a), dtype=fake.dtype)

    def tree(a, fake):
        if isinstance(fake, dict):
            return {k: tree(a[k], v) for k, v in fake.items()}
        return like(a, fake)
    opt_init = make_optimizer(OptConfig(name=b.opt_name or "adamw",
                                        lr=1e-3))[0]
    if kind in ("decode", "prefill", "recsys_serve"):
        rest = _args(kind, params, None, data)[1:]
        return (params,) + tuple(tree(a, f) for a, f in zip(rest,
                                                            b.args[1:]))
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "nan_skips": torch.zeros((), dtype=torch.int32)}
    return (state, tree(data, b.args[1]))


def restore_split(mesh, ckpt_dir):
    """Rank 0 saves a gemma-2b SMOKE AdamW train state; every rank
    restores it split by the train step's state shardings. Returns, in
    leaf order, each leaf's path, placements and whether its
    ``full_tensor()`` equals the saved array, byte for byte."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.train import checkpoint
    from repro_torch.train.tree import leaves_with_paths, tree_map

    cid = "gemma-2b/train"
    b, params, data = _port_inputs(cid, mesh)
    state = _port_args("train", b, params, data)[0]
    state["opt"]["m"] = tree_map(lambda t: t + 0.5, state["opt"]["m"])
    if dist.get_rank() == 0:
        checkpoint.save(ckpt_dir, 1, state)
    dist.barrier()
    like = tree_map(torch.zeros_like, state)
    got, _ = checkpoint.restore(ckpt_dir, like,
                                shardings=b.in_shardings[0], mesh=mesh)
    out = []
    for i, (path, t) in enumerate(leaves_with_paths(got)):
        saved = np.load(os.path.join(ckpt_dir, "step_00000001", "arrays",
                                     f"{i}.npy"))
        full = t.full_tensor().numpy() if isinstance(t, DTensor) else None
        out.append(("/".join(path), tuple(
            f"S{pl.dim}" if pl.is_shard() else "R" for pl in t.placements)
            if isinstance(t, DTensor) else None,
                    full is not None and full.tobytes() == saved.tobytes()
                    and full.shape == saved.shape))
    return out


def _full(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.train.tree import leaves_with_paths
    return {"/".join(p): (v.full_tensor() if isinstance(v, DTensor) else v)
            .detach().numpy() for p, v in leaves_with_paths(tree)}


def adafactor_split(mesh):
    """One Adafactor update of gemma-2b SMOKE parameters (its factored
    slots laid out as ``launch.steps`` lays them out) on DTensors, and
    the same update on plain tensors: ``(split, plain)`` numpy trees."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models.common import distribute
    from repro_torch.train.optimizer import OptConfig, adafactor_init, \
        adafactor_update
    from repro_torch.train.tree import tree_map

    b, params, _ = _port_inputs("gemma-2b/train", mesh)
    specs = _case_model("gemma-2b/train")[2]
    gen = torch.Generator().manual_seed(5)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    cfg = OptConfig(name="adafactor", lr=1e-3, min_dim_factored=32)
    state = adafactor_init(params, cfg)
    plain = adafactor_update(grads, state, params, cfg)
    param_sh = b.in_shardings[0]["params"]
    slot_sh = steps._opt_shardings("adafactor", specs, param_sh, mesh,
                                   min_dim_factored=32)
    split = adafactor_update(
        distribute(grads, param_sh, mesh),
        {"slots": distribute(state["slots"], slot_sh["slots"], mesh),
         "step": state["step"]},
        distribute(params, param_sh, mesh), cfg)
    return _full(split), _full(plain)


def microbatches_split(mesh):
    """gemma-2b SMOKE's train step at microbatches=2 on DTensors and on
    plain tensors, from the same state: ``(split, plain)`` numpy
    trees."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import NULL_CTX, ShardCtx
    from repro_torch.models import transformer as T
    from repro_torch.models.common import distribute
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import make_train_step

    b, params, data = _port_inputs("gemma-2b/train", mesh)
    cfg = _case_model("gemma-2b/train")[0].config
    args = _port_args("train", b, params, data)
    out = {}
    for name, ctx in (("split", ShardCtx(mesh)), ("plain", NULL_CTX)):
        _, step = make_train_step(
            lambda p, x, ctx=ctx: T.loss_fn(p, x, cfg, ctx),
            OptConfig(name="adamw", lr=1e-3), microbatches=2)
        if name == "split":
            with implicit_replication():
                out[name] = _full(step(*distribute(args, b.in_shardings,
                                                   mesh)))
        else:
            out[name] = _full(step(*args))
    return out["split"], out["plain"]


def _rank(rank, port, out_path):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    (shape, names) = MESH_2X2
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=names)
    res = {}
    for cid, *_ in CASES:
        res[cid] = {"split": port_case(cid, mesh)}
        if rank == 0:
            res[cid]["unsplit"] = port_case(cid, None)
    res["checkpoint"] = restore_split(mesh, os.path.join(
        os.path.dirname(os.path.abspath(out_path)), "ckpt"))
    res["adafactor"] = adafactor_split(mesh)
    res["microbatches"] = microbatches_split(mesh)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(res, f)


def _port_main(out_path):
    import torch.multiprocessing as mp
    from torch_dist_jobs import held_port
    with held_port() as port:
        mp.start_processes(_rank, args=(port, out_path), nprocs=4,
                           start_method="spawn")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    if sys.argv[1] == "ref":
        _ref_main(sys.argv[2])
    else:
        _port_main(sys.argv[2])
