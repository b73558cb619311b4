"""Restartable checkpointing — port of ``repro.train.checkpoint``, in its
on-disk format, so a checkpoint written by either package restores in
the other.

Layout:  <dir>/step_<N>/
            manifest.json       — step, every leaf's path, index, shape
                                  and dtype, and the caller's ``extra``
            arrays/<idx>.npy    — one file per leaf

Leaves are numbered in the reference's order (``train.tree``: dict keys
sorted, sequences by index) and their paths rendered as
``tree_flatten_with_path`` renders them (``opt/m/layers/wq``). A save is
written under ``step_<N>.tmp`` and published by one rename. A bfloat16
leaf is written as the reference writes one: the header of type
``<V2``, two bytes an element, ``"bfloat16"`` in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from ..dist.sharding import placements
from ..models.common import map_with_specs
from .tree import leaves, leaves_with_paths, unflatten


def _save_leaf(path: str, leaf) -> Tuple[int, ...]:
    """Write ``leaf`` as ``.npy``; returns its shape."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype != torch.bfloat16:
        arr = t.numpy()
        np.save(path, arr)
        return arr.shape
    # numpy has no bfloat16: the reference's (ml_dtypes) header, then
    # the two-byte elements
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.contiguous().view(torch.int16).numpy().tobytes())
    return tuple(t.shape)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def save(ckpt_dir: str, step: int, state: Any,
         extra: Optional[Dict] = None) -> str:
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, leaf) in enumerate(leaves_with_paths(state)):
        shape = _save_leaf(os.path.join(tmp, "arrays", f"{i}.npy"), leaf)
        manifest["leaves"].append(
            {"path": "/".join(path), "idx": i, "shape": list(shape),
             "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # atomic publish: rename tmp -> final (crash-safe)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    return out


def _steps(ckpt_dir: str):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _load(path: str, like: torch.Tensor, device) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V":                 # bfloat16, two bytes each
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=like.dtype)


class _Spec:
    """A spec tuple held as one leaf (``tree.leaves`` walks tuples)."""

    def __init__(self, spec):
        self.spec = tuple(spec)


def restore(ckpt_dir: str, state_like: Any, step: Optional[int] = None,
            shardings: Any = None, device=None,
            mesh: Optional[DeviceMesh] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``state_like``; returns ``(state,
    extra)``. Each leaf takes its ``state_like`` leaf's dtype and goes
    to ``device``, or where that leaf is. ``shardings`` is a tree of
    spec tuples in the structure of the state
    (``dist.sharding.spec_shardings``); with a ``DeviceMesh`` every leaf
    comes back as a DTensor laid out by its spec, each rank keeping its
    own piece of the saved array (the reference's ``device_put``).
    Without one a spec that splits an array raises
    ``NotImplementedError``, as ``ShardCtx.constrain`` does on a mesh
    that has no ranks."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    like = leaves(state_like)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"structure mismatch: {len(like)} leaves, the "
                         f"checkpoint has {len(manifest['leaves'])}")
    specs = [None] * len(like)
    if shardings is not None:
        specs = [s.spec for s in leaves(map_with_specs(
            lambda _, spec: _Spec(spec), state_like, shardings))]
        split = [s for s in specs if any(e is not None for e in s)]
        if split and not isinstance(mesh, DeviceMesh):
            raise NotImplementedError(
                f"restore: the shardings split an array ({split[0]}); a "
                "split needs a DeviceMesh")
    out = []
    for i, leaf in enumerate(like):
        t = _load(os.path.join(src, "arrays", f"{i}.npy"), leaf,
                  device if device is not None else leaf.device)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{manifest['leaves'][i]['path']}: shape "
                             f"{tuple(t.shape)}, the state's is "
                             f"{tuple(leaf.shape)}")
        if specs[i] is not None and isinstance(mesh, DeviceMesh):
            t = distribute_tensor(t, mesh, placements(specs[i], mesh),
                                  src_data_rank=None)
        out.append(t)
    return unflatten(state_like, out), manifest["extra"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
