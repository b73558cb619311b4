"""Carry the input state from the JAX package's objects into the port's.

The partitioner has no weights; what crosses over is the input: a graph
(the reference ``Graph``'s four CSR fields as numpy arrays), a
distributed graph (a reference ``GraphShards``' fields), a configuration
(``dataclasses.asdict`` of a reference ``PartitionerConfig``: the
distributed memory model's ``contraction`` / ``balance`` / ``weights``
are among its fields) and a request (its fields: ``backend`` carries the
routing of the distributed engine's collectives, ``dist-grid`` being the
reference's ``use_grid=True``). Tests hand both packages the same input, and the
serving tests the same traffic, through these, without this package
importing the reference. The models' weights cross by spec key
(``model_from``), a KV cache (``cache_from``), and an optimizer or
train state (``opt_state_from``, ``train_state_from``) with them, so
both packages train on from the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .core.deep_mgp import PartitionerConfig
from .graphs.distribute import GraphShards
from .graphs.format import Graph


def graph_from_arrays(indptr, adjncy, eweights, vweights) -> Graph:
    """The port's ``Graph`` over copies of the four CSR arrays."""
    return Graph(indptr=np.array(indptr, dtype=np.int64),
                 adjncy=np.array(adjncy),
                 eweights=np.array(eweights, dtype=np.int64),
                 vweights=np.array(vweights, dtype=np.int64))


def config_from_dict(d: Mapping[str, Any]) -> PartitionerConfig:
    """The port's ``PartitionerConfig`` from a reference config's fields;
    an unknown field raises ``TypeError``."""
    return PartitionerConfig(**dict(d)).validate()


def shards_from(shards) -> GraphShards:
    """The port's ``GraphShards`` over copies of a reference
    ``GraphShards``' fields (any object with them)."""
    return GraphShards(**{
        f.name: (np.array(getattr(shards, f.name))
                 if isinstance(getattr(shards, f.name), np.ndarray)
                 else int(getattr(shards, f.name)))
        for f in dataclasses.fields(GraphShards)})


def request_from_fields(fields: Mapping[str, Any]):
    """The port's ``PartitionRequest`` from a reference request's fields
    (``{f.name: getattr(req, f.name) for f in dataclasses.fields(req)}``).

    ``graph`` is a generator spec (its ``family``, ``n``, ``avg_deg``
    and ``seed``) or a graph (its CSR arrays are copied); ``config``, if
    set, a config dataclass (its fields are copied). Every other field
    (k, epsilon, preset, seed, backend, devices, refine, quality, ...)
    crosses as it is."""
    from .api.request import GraphSpec, PartitionRequest

    f = dict(fields)
    g = f.pop("graph")
    if hasattr(g, "family"):
        graph = GraphSpec(g.family, g.n, g.avg_deg, g.seed)
    else:
        graph = graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                  g.vweights)
    if f.get("config") is not None:
        f["config"] = config_from_dict(dataclasses.asdict(f["config"]))
    return PartitionRequest(graph=graph, **f)


LM_ARCHS = ("qwen2-7b", "gemma-2b", "stablelm-12b", "granite-moe-1b-a400m",
            "arctic-480b")


def _model_module(arch_id: str):
    from .models import dlrm, transformer
    from .models.gnn import dimenet, gat, nequip, schnet
    if arch_id in LM_ARCHS:
        return transformer
    return {"gat-cora": gat, "schnet": schnet, "nequip": nequip,
            "dimenet": dimenet, "dlrm-rm2": dlrm}[arch_id]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of the same name as ``dtype`` (a torch dtype, a
    numpy dtype, or a scalar type such as the reference's
    ``jnp.float32``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype is named {name!r}")
    return out


def config_of(arch_id: str, fields: Mapping[str, Any]):
    """The port's config of ``arch_id`` from a reference config's fields
    (``dataclasses.asdict``); dtype fields are mapped by name."""
    from . import configs
    cls = type(configs.get(arch_id).config)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            v = fields[f.name]
            kw[f.name] = torch_dtype(v) if isinstance(
                f.default, torch.dtype) else v
    unknown = set(fields) - set(kw)
    if unknown:
        raise TypeError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kw)


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy has no such type
        a = a.astype(np.float32)           # exact
    return torch.tensor(a, dtype=dtype, device=device)


def model_from(arch_id: str, arrays: Mapping[str, Any],
               fields: Mapping[str, Any], device=None) -> Tuple[Dict, Any]:
    """``(params, cfg)`` of the port for a reference parameter tree
    (numpy arrays under the reference's spec keys, nested dicts alike)
    and config fields. Every spec key must be there with its spec's
    shape; each tensor takes its spec's dtype, on ``device`` (the card
    by default)."""
    from .kernels.dispatch import resolve_device
    from .models.common import is_spec

    device = resolve_device(device)
    cfg = config_of(arch_id, fields)
    specs = _model_module(arch_id).build_specs(cfg)

    def build(spec_tree, tree, path):
        if is_spec(spec_tree):
            a = np.asarray(tree)
            if tuple(a.shape) != tuple(spec_tree.shape):
                raise ValueError(f"{'/'.join(path)}: shape {a.shape}, the "
                                 f"spec's is {spec_tree.shape}")
            return _tensor(a, spec_tree.dtype, device)
        if set(tree) != set(spec_tree):
            raise KeyError(f"{'/'.join(path) or 'params'}: keys "
                           f"{sorted(set(tree) ^ set(spec_tree))} differ "
                           "from the spec tree's")
        return {k: build(v, tree[k], path + (k,))
                for k, v in spec_tree.items()}
    return build(specs, arrays, ()), cfg


def cache_from(arrays: Mapping[str, Any], device=None) -> Dict:
    """A reference KV cache (``{"k", "v"}``, numpy arrays of (L, B,
    S_max, Hkv, hd), bf16 included) as the port's tensors on ``device``
    (the card by default), each in its array's dtype, so that decoding
    resumes on the reference's state."""
    from .kernels.dispatch import resolve_device

    device = resolve_device(device)
    if set(arrays) != {"k", "v"}:
        raise KeyError(f"a KV cache has the keys k and v, not "
                       f"{sorted(arrays)}")
    k, v = np.asarray(arrays["k"]), np.asarray(arrays["v"])
    if k.shape != v.shape or k.ndim != 5:
        raise ValueError(f"cache k {k.shape} and v {v.shape}: both must be "
                         "(L, B, S_max, Hkv, hd)")
    return {n: _tensor(a, torch_dtype(a.dtype), device)
            for n, a in (("k", k), ("v", v))}


def graph_batch_from(fields: Mapping[str, Any], device=None):
    """The port's ``GraphBatch`` from a reference batch's fields (arrays
    as numpy, ``n_node`` and ``n_graphs`` as ints), on ``device``."""
    from .kernels.dispatch import resolve_device
    from .models.gnn.common import GraphBatch

    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(GraphBatch):
        v = fields.get(f.name)
        if f.name in ("n_node", "n_graphs"):
            kw[f.name] = int(v) if v is not None else f.default
        elif v is not None:
            kw[f.name] = torch.as_tensor(np.asarray(v), device=device)
    return GraphBatch(**kw)


def dlrm_batch_from(batch: Mapping[str, Any], device=None) -> Dict:
    """A DLRM batch (``dense``, ``sparse``, ``labels``, ``candidates``:
    whichever are there) as tensors on ``device``."""
    from .kernels.dispatch import resolve_device

    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def opt_state_from(opt_name: str, arrays: Mapping[str, Any],
                   params) -> Dict:
    """A reference optimizer state (numpy leaves: AdamW ``{"m", "v",
    "step"}``, Adafactor ``{"slots", "step"}``) as the port's, next to
    the port's ``params`` (its moments float32 on their device, ``step``
    int32). Every moment must match its parameter: ``m`` / ``v`` its
    shape, an Adafactor slot ``{"v"}`` its shape or ``{"vr", "vc"}`` its
    row and column shapes."""
    from .train.optimizer import slots_of
    from .train.tree import leaves_with_paths, unflatten

    flat = leaves_with_paths(params)
    dev = flat[0][1].device

    def moment(a, shape, what):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{what}: shape {a.shape}, want {tuple(shape)}")
        return _tensor(a, torch.float32, dev)

    if opt_name == "adamw":
        out = {}
        for n in ("m", "v"):
            got = leaves_with_paths(arrays[n])
            if [q for q, _ in got] != [q for q, _ in flat]:
                raise KeyError(f"{n}: its leaves are not the parameters'")
            out[n] = unflatten(params, [
                moment(a, p.shape, f"{n}/{'/'.join(path)}")
                for (path, p), (_, a) in zip(flat, got)])
    elif opt_name == "adafactor":
        slots = []
        for (path, p), s in zip(flat, slots_of(params, arrays["slots"])):
            what = "slots/" + "/".join(path)
            shapes = ({"v": p.shape} if set(s) == {"v"} else
                      {"vr": p.shape[:-1],
                       "vc": tuple(p.shape[:-2]) + tuple(p.shape[-1:])})
            if set(s) != set(shapes):
                raise KeyError(f"{what}: keys {sorted(s)}")
            slots.append({k: moment(s[k], shp, f"{what}/{k}")
                          for k, shp in shapes.items()})
        out = {"slots": unflatten(params, slots)}
    else:
        raise ValueError(f"unknown optimizer {opt_name!r}")
    out["step"] = _tensor(arrays["step"], torch.int32, dev)
    return out


def train_state_from(arch_id: str, opt_name: str,
                     arrays: Mapping[str, Any], fields: Mapping[str, Any],
                     device=None) -> Tuple[Dict, Any]:
    """``(state, cfg)``: a reference train state (``{"params", "opt",
    "step", "nan_skips"}`` with numpy leaves) and config fields as the
    port's, on ``device`` (the card by default), so both packages train
    on from the same state."""
    from .train.tree import leaves

    params, cfg = model_from(arch_id, arrays["params"], fields,
                             device=device)
    dev = leaves(params)[0].device
    return {"params": params,
            "opt": opt_state_from(opt_name, arrays["opt"], params),
            "step": _tensor(arrays["step"], torch.int32, dev),
            "nan_skips": _tensor(arrays["nan_skips"], torch.int32, dev)
            }, cfg
