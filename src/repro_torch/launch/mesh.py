"""Production mesh builders — port of ``repro.launch.mesh`` (functions,
not module constants: importing this module touches no process group).

The reference's pod is a 16 x 16 v5e torus. On H100 nodes the same 256
cards are 32 nodes of 8: the ``model`` (tensor) axis stays inside one
node's NVLink, and ``data`` runs across nodes. A 16-wide tensor axis
would cross InfiniBand.

Each builder lays ranks 0..n-1 of the default process group, real or
fake (``dryrun.py`` starts a ``"fake"`` group of the mesh's size), out
as a ``DeviceMesh``; a mesh larger than the group is an error.
"""
from __future__ import annotations

import math
from typing import Tuple


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..kernels.dispatch import resolve_device

    dev = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a default process group "
                           "(real, or 'fake' for a dry-run)")
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return DeviceMesh(dev, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """256 cards as ``("data", "model") = (32, 8)``; ``multi_pod`` adds a
    leading ``pod`` axis of 2 (512 cards)."""
    if multi_pod:
        return _mesh((2, 32, 8), ("pod", "data", "model"), device)
    return _mesh((32, 8), ("data", "model"), device)


def make_node_mesh(device="cuda"):
    """One 8-card node: ``("data", "model") = (1, 8)``."""
    return _mesh((1, 8), ("data", "model"), device)


def make_card_mesh(device="cuda"):
    """One card: ``("data", "model") = (1, 1)``."""
    return _mesh((1, 1), ("data", "model"), device)


def make_host_mesh(p: int, device=None):
    """1D 'pe' mesh over p rank processes — alias of the mesh the
    distributed partitioner builds (``dist.dist_lp.make_mesh_1d``)."""
    from ..dist.dist_lp import make_mesh_1d
    return make_mesh_1d(p, device)
