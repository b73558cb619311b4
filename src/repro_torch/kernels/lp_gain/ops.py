"""Graph -> padded ELL -> ``lp_gain`` kernel.

``prepare_ell`` is the JAX package's ``repro/kernels/lp_gain/ops.py::
prepare_ell`` (the same arrays); the neighbour-label and target-weight
gathers run as torch ops on the device. Rows are padded to a multiple
of ``row_tile`` and lanes to a multiple of ``lanes``: 32, a warp, by
default in ``gain_operands`` and ``lp_gain`` (the kernel holds a row's
lanes in registers, 32 a tile), 128 as in the reference in
``prepare_ell``. Padded lanes carry label -1, weight 0 and target weight
+inf, padded rows own label -2, so none of them can fit or match and the
lane width never changes ``(gain, target, own_conn)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...graphs.format import Graph, to_ell
from ..dispatch import resolve_device
from .lp_gain import lp_gain_ell


def _pad_to(x, m, axis, fill):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, m - x.shape[axis])
    return np.pad(x, pad, constant_values=fill)


def prepare_ell(g: Graph, row_tile: int = 256, max_degree: int = 512,
                lanes: int = 128) -> Tuple[np.ndarray, np.ndarray, int]:
    """Graph -> padded (idx, w) ELL arrays: D a multiple of ``lanes`` (at
    least ``lanes``), rows a multiple of row_tile. Sentinel neighbor id =
    -1. Rows longer than ``max_degree`` are truncated, as ``to_ell``
    truncates them. ``lanes=128`` gives the reference's arrays."""
    idx, wgt, d = to_ell(g, max_degree=max_degree)
    d_pad = max(lanes, -(-d // lanes) * lanes)
    n_pad = -(-g.n // row_tile) * row_tile
    idx = np.where(idx >= g.n, -1, idx)
    idx = _pad_to(_pad_to(idx, d_pad, 1, -1), n_pad, 0, -1)
    wgt = _pad_to(_pad_to(wgt, d_pad, 1, 0), n_pad, 0, 0)
    return idx.astype(np.int32), wgt.astype(np.float32), d_pad


def gain_operands(g: Graph, labels: np.ndarray, cluster_w: np.ndarray,
                  budget: float, row_tile: int, device: torch.device,
                  lanes: int = 32):
    """The kernel's six operands on ``device``: neighbour labels, arc
    weights and neighbour cluster weights (n_pad, D), D a multiple of
    ``lanes``, own label and vertex weight (n_pad, 1), the budget (1, 1)."""
    if labels.shape != (g.n,):
        raise ValueError(f"lp_gain: expected {g.n} labels, got shape "
                         f"{labels.shape}")
    if labels.size and labels.max() >= cluster_w.shape[0]:
        raise ValueError(f"lp_gain: label {labels.max()} has no cluster "
                         f"weight (cluster_w holds {cluster_w.shape[0]})")
    idx, wgt, _ = prepare_ell(g, row_tile, lanes=lanes)
    n_pad = idx.shape[0]
    idx = torch.from_numpy(idx).to(device)
    lab_tab = torch.from_numpy(np.concatenate(
        [labels.astype(np.int32), [-1]]).astype(np.int32)).to(device)
    cw_tab = torch.from_numpy(np.concatenate(
        [cluster_w.astype(np.float32), [np.inf]]).astype(np.float32)
    ).to(device)
    valid = idx >= 0
    nbr_lab = torch.where(valid, lab_tab[torch.where(valid, idx, 0).long()],
                          -1)
    has = nbr_lab >= 0
    tgt_w = torch.where(has, cw_tab[torch.where(has, nbr_lab, 0).long()],
                        float("inf"))
    own = torch.full((n_pad, 1), -2, dtype=torch.int32, device=device)
    own[:g.n, 0] = lab_tab[:g.n]
    vw = torch.zeros((n_pad, 1), dtype=torch.float32, device=device)
    vw[:g.n, 0] = torch.from_numpy(g.vweights.astype(np.float32)).to(device)
    bud = torch.full((1, 1), budget, dtype=torch.float32, device=device)
    return (nbr_lab, torch.from_numpy(wgt).to(device), tgt_w, own, vw, bud)


def lp_gain(g: Graph, labels: np.ndarray, cluster_w: np.ndarray,
            budget: float, row_tile: int = 256, device=None,
            lanes: int = 32):
    """``(gain, target, own_conn)`` per vertex, numpy (n,) f32 / int32 /
    f32, through the ``lp_gain`` kernel on ``device`` (default: the CUDA
    device; ``"cpu"`` runs the plain version). ``lanes``: the ELL rows'
    lane padding (32 a warp; 128 the reference's), which never changes
    the result.

    labels/cluster_w indexed by vertex id / label id respectively."""
    dev = resolve_device(device)
    best, target, own_conn = lp_gain_ell(
        *gain_operands(g, labels, cluster_w, budget, row_tile, dev, lanes),
        row_tile=row_tile)
    n = g.n
    gain = best[:n, 0] - own_conn[:n, 0]
    return (gain.cpu().numpy(), target[:n, 0].cpu().numpy(),
            own_conn[:n, 0].cpu().numpy())
