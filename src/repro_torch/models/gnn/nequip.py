"""NequIP (Batzner et al., arXiv:2101.03164) — E(3)-equivariant
interatomic potential with tensor-product message passing, l_max = 2 —
port of ``repro.models.gnn.nequip``.

Irreps are carried in *Cartesian* form, as the reference carries them:
l=0 scalars (N, C), l=1 vectors (N, C, 3), l=2 traceless symmetric
matrices (N, C, 3, 3). Every Clebsch-Gordan path below is an explicit
Cartesian contraction, in the reference's einsum order, so equivariance
is testable with rotation matrices (vectors -> Rv, tensors -> R T R^T).

Config: 5 layers, multiplicity 32, 8 Bessel RBFs, cutoff 5.0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ...dist.sharding import NULL_CTX, ShardCtx, reshape, rowwise
from ..common import ParamSpec
from .common import (GraphBatch, bessel_rbf, cosine_cutoff, edge_vectors,
                     graph_energy, scatter_sum)

# the Levi-Civita symbol, float32 as the reference's constant
_e = np.zeros((3, 3, 3), dtype=np.float32)
_e[0, 1, 2] = _e[1, 2, 0] = _e[2, 0, 1] = 1.0
_e[0, 2, 1] = _e[2, 1, 0] = _e[1, 0, 2] = -1.0
_EPS = torch.from_numpy(_e)


def sym_traceless(t):
    """Project (..., 3, 3) onto the l=2 (symmetric traceless) component."""
    s = 0.5 * (t + t.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * torch.eye(3, dtype=t.dtype, device=t.device) / 3.0


def edge_harmonics(rhat):
    """Cartesian 'spherical harmonics' of unit vectors, l = 0, 1, 2."""
    y0 = torch.ones(rhat.shape[:-1] + (1,), dtype=rhat.dtype,
                    device=rhat.device)
    y1 = rhat
    y2 = sym_traceless(rhat[..., :, None] * rhat[..., None, :])
    return {0: y0, 1: y1, 2: y2}


def cart_tp(l1: int, a, l2: int, b) -> Dict[int, torch.Tensor]:
    """Cartesian Clebsch-Gordan product of per-channel irreps.

    a: (..., C, [3]*l1-shape), b broadcastable likewise. Returns the l_out
    components reachable with l_out <= 2."""
    out: Dict[int, torch.Tensor] = {}
    if l1 > l2:  # symmetrize dispatch
        return cart_tp(l2, b, l1, a)
    if l1 == 0:
        # scalar times anything: shapes (...,C) x (...,C,...)
        extra = b.dim() - a.dim()
        out[l2] = a.reshape(a.shape + (1,) * extra) * b
        return out
    if l1 == 1 and l2 == 1:
        out[0] = torch.sum(a * b, dim=-1)
        out[1] = torch.linalg.cross(a, b, dim=-1)
        out[2] = sym_traceless(a[..., :, None] * b[..., None, :])
        return out
    if l1 == 1 and l2 == 2:
        # vector . matrix -> vector
        out[1] = torch.einsum("...i,...ij->...j", a, b)
        # antisymmetric route -> l=2: sym traceless of (eps contraction)
        c = torch.linalg.cross(a[..., None, :].expand_as(b), b, dim=-1)
        out[2] = sym_traceless(c)
        return out
    if l1 == 2 and l2 == 2:
        eps = _EPS.to(a.device)
        out[0] = torch.einsum("...ij,...ij->...", a, b)
        out[1] = torch.einsum("ijk,...jl,...lk->...i", eps, a, b)
        ab = torch.einsum("...ij,...jk->...ik", a, b)
        ba = torch.einsum("...ij,...jk->...ik", b, a)
        out[2] = sym_traceless(ab + ba)
        return out
    raise ValueError((l1, l2))


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32       # multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 100
    radial_hidden: int = 32


# paths: (l_in, l_filter) -> l_out, all <= l_max
PATHS: Tuple[Tuple[int, int, int], ...] = tuple(
    (li, lf, lo)
    for li in (0, 1, 2) for lf in (0, 1, 2) for lo in (0, 1, 2)
    if abs(li - lf) <= lo <= li + lf)


def build_specs(cfg: NequIPConfig) -> Dict[str, Any]:
    C = cfg.d_hidden
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.n_species, C), (None, "feat"),
                           init="embed", scale=1.0),
    }
    for i in range(cfg.n_layers):
        # radial MLP -> per-path, per-channel weights
        specs[f"l{i}_rw0"] = ParamSpec((cfg.n_rbf, cfg.radial_hidden),
                                       (None, None))
        specs[f"l{i}_rb0"] = ParamSpec((cfg.radial_hidden,), (None,),
                                       init="zeros")
        specs[f"l{i}_rw1"] = ParamSpec((cfg.radial_hidden, len(PATHS) * C),
                                       (None, None))
        for lo in (0, 1, 2):
            specs[f"l{i}_mix{lo}"] = ParamSpec((C, C), ("feat", "feat"),
                                               scale=0.5)
            if lo > 0:
                specs[f"l{i}_gate{lo}"] = ParamSpec((C, C), ("feat", "feat"),
                                                    scale=0.5)
    specs.update({
        "out_w0": ParamSpec((C, C), ("feat", None)),
        "out_b0": ParamSpec((C,), (None,), init="zeros"),
        "out_w1": ParamSpec((C, 1), (None, None)),
        "out_b1": ParamSpec((1,), (None,), init="zeros"),
    })
    return specs


def forward(params, batch: GraphBatch, cfg: NequIPConfig,
            ctx: ShardCtx = NULL_CTX):
    """Per-graph energies (n_graphs,) — rotation invariant."""
    N, C = batch.n_node, cfg.d_hidden
    rij, d, emask = edge_vectors(batch)
    rhat = rij / d[:, None]
    Y = edge_harmonics(rhat)
    rbf = ctx.constrain(bessel_rbf(d, cfg.n_rbf, cfg.cutoff),
                        "edges", None)
    fc = (cosine_cutoff(d, cfg.cutoff) * emask)[:, None]
    snd, rcv = batch.senders.long(), batch.receivers.long()
    emb = params["embed"][batch.species.long()]
    x = {0: emb,
         1: emb.new_zeros((N, C, 3)),
         2: emb.new_zeros((N, C, 3, 3))}

    for i in range(cfg.n_layers):
        h = F.silu(rbf @ params[f"l{i}_rw0"] + params[f"l{i}_rb0"])
        w = reshape(h @ params[f"l{i}_rw1"], (-1, len(PATHS), C)) * \
            fc[:, :, None]                                 # (E, P, C)
        agg = {lo: 0.0 for lo in (0, 1, 2)}
        for pi, (li, lf, lo) in enumerate(PATHS):
            xj = x[li][snd]                                # (E, C, ...)
            if lf == 0:
                prod = {li: xj}
            else:
                yf = Y[lf][:, None]                        # (E, 1, ...)
                yf = yf.expand((xj.shape[0], C) + tuple(Y[lf].shape[1:]))
                prod = rowwise(lambda a, b: cart_tp(li, a, lf, b),
                               xj, yf) if isinstance(xj, DTensor) \
                    else cart_tp(li, xj, lf, yf)
            if lo not in prod:
                continue
            m = prod[lo]
            wc = w[:, pi].reshape((w.shape[0], C) + (1,) * (m.dim() - 2))
            m = ctx.constrain(m * wc, "edges", *([None] * (m.dim() - 1)))
            agg[lo] = agg[lo] + scatter_sum(m, rcv, N)
        # linear mix + gated nonlinearity, residual update
        agg = {lo: ctx.constrain(a, "nodes", *([None] * (a.dim() - 1)))
               for lo, a in agg.items()}
        s = x[0] + torch.tanh(agg[0]) @ params[f"l{i}_mix0"]
        new = {0: s}
        for lo in (1, 2):
            g = torch.sigmoid(s @ params[f"l{i}_gate{lo}"])
            mixed = torch.einsum("nc...,cd->nd...", agg[lo],
                                 params[f"l{i}_mix{lo}"])
            new[lo] = x[lo] + mixed * \
                g.reshape(g.shape + (1,) * (x[lo].dim() - 2))
        x = new

    e_atom = F.silu(x[0] @ params["out_w0"] + params["out_b0"])
    e_atom = e_atom @ params["out_w1"] + params["out_b1"]
    return graph_energy(e_atom, batch)


def loss_fn(params, batch: GraphBatch, cfg: NequIPConfig,
            ctx: ShardCtx = NULL_CTX):
    energies = forward(params, batch, cfg, ctx)
    return torch.mean(torch.square(energies - batch.labels))
