"""DimeNet (Gasteiger et al., arXiv:2003.03123) — directional message
passing over edge-pair (triplet) gathers with a joint 2D spherical
Fourier-Bessel basis — port of ``repro.models.gnn.dimenet``.

Config: 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import optimize, special
from torch.distributed.tensor import DTensor

from ...dist.sharding import NULL_CTX, ShardCtx, rowwise
from ..common import ParamSpec
from .common import (GraphBatch, bessel_rbf, cosine_cutoff, edge_vectors,
                     graph_energy, norm, scatter_sum)


@functools.lru_cache(maxsize=None)
def spherical_bessel_roots(n_l: int, n_roots: int) -> np.ndarray:
    """First ``n_roots`` positive roots of j_l for l < n_l (computed once
    by sign-change scan + brentq)."""
    out = np.zeros((n_l, n_roots))
    xs = np.linspace(1e-3, 60.0, 6000)
    for l in range(n_l):
        vals = special.spherical_jn(l, xs)
        sgn = np.sign(vals)
        flips = np.flatnonzero(sgn[1:] * sgn[:-1] < 0)
        roots = []
        for f in flips[:n_roots]:
            roots.append(optimize.brentq(
                lambda x: special.spherical_jn(l, x), xs[f], xs[f + 1]))
        out[l, :len(roots)] = roots
    return out


def spherical_jn(l_max: int, x):
    """j_l(x) for l = 0..l_max via upward recurrence (x bounded away
    from 0), returned in x's dtype.

    The recurrence runs in float64. Below x ~ l it multiplies an ulp of
    sin or cos by ~(2l+1)/x a step, and the reference's float32 loses
    every digit of j_6 there: at the full config (l up to 6; x of 0.5-3
    on molecules) its energies then turn on the last ulp of a position,
    and on which sin and cos a device has. In float64 they do not, and
    where float32 holds (l <= 3 as in the smoke config, or x >= 3) both
    packages agree within the models' tolerance
    (``tests/test_torch_models.py`` pins both)."""
    dtype = x.dtype
    x = torch.clamp(x.double(), min=1e-4)
    j = [torch.sin(x) / x]
    if l_max >= 1:
        j.append(torch.sin(x) / (x * x) - torch.cos(x) / x)
    for l in range(1, l_max):
        j.append((2 * l + 1) / x * j[l] - j[l - 1])
    return torch.stack(j, dim=-1).to(dtype)          # (..., l_max+1)


def legendre(l_max: int, c):
    p = [torch.ones_like(c)]
    if l_max >= 1:
        p.append(c)
    for l in range(1, l_max):
        p.append(((2 * l + 1) * c * p[l] - l * p[l - 1]) / (l + 1))
    return torch.stack(p, dim=-1)          # (..., l_max+1)


def build_triplets(senders: np.ndarray, receivers: np.ndarray, n_node: int,
                   cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side triplet index lists: pairs (e_kj, e_ji) sharing middle
    vertex j with k != i. Padded to ``cap`` with sentinel E."""
    E = senders.shape[0]
    valid = senders < n_node - 1
    order = np.argsort(senders, kind="stable")     # edges grouped by src j
    by_src_start = np.searchsorted(senders[order], np.arange(n_node + 1))
    kj_list, ji_list = [], []
    in_edges = [[] for _ in range(n_node)]
    for e in range(E):
        if valid[e]:
            in_edges[receivers[e]].append(e)
    for j in range(n_node - 1):
        out_es = order[by_src_start[j]:by_src_start[j + 1]]
        for e2 in out_es:                          # e2: j -> i
            if not valid[e2]:
                continue
            i = receivers[e2]
            for e1 in in_edges[j]:                 # e1: k -> j
                if senders[e1] != i:
                    kj_list.append(e1)
                    ji_list.append(e2)
    T = len(kj_list)
    kj = np.full(cap, E, dtype=np.int32)
    ji = np.full(cap, E, dtype=np.int32)
    take = min(T, cap)
    kj[:take] = np.asarray(kj_list[:take], dtype=np.int32)
    ji[:take] = np.asarray(ji_list[:take], dtype=np.int32)
    return kj, ji


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 100
    envelope_p: int = 6


def build_specs(cfg: DimeNetConfig) -> Dict[str, Any]:
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsbf = cfg.n_spherical * cfg.n_radial
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.n_species, d), (None, "feat"),
                           init="embed", scale=1.0),
        "emb_rbf_w": ParamSpec((cfg.n_radial, d), (None, "feat")),
        "emb_w": ParamSpec((3 * d, d), (None, "feat")),
        "emb_b": ParamSpec((d,), ("feat",), init="zeros"),
    }
    for i in range(cfg.n_blocks):
        specs.update({
            f"b{i}_rbf_w": ParamSpec((cfg.n_radial, d), (None, "feat")),
            f"b{i}_sbf_w": ParamSpec((nsbf, nb), (None, None)),
            f"b{i}_down": ParamSpec((d, nb), ("feat", None)),
            f"b{i}_up": ParamSpec((nb, d), (None, "feat")),
            f"b{i}_msg_w": ParamSpec((d, d), ("feat", "feat")),
            f"b{i}_msg_b": ParamSpec((d,), ("feat",), init="zeros"),
            f"b{i}_res_w": ParamSpec((d, d), ("feat", "feat"), scale=0.5),
            f"b{i}_res_b": ParamSpec((d,), ("feat",), init="zeros"),
            f"b{i}_out_rbf": ParamSpec((cfg.n_radial, d), (None, "feat")),
            f"b{i}_out_w": ParamSpec((d, d), ("feat", "feat")),
            f"b{i}_out_b": ParamSpec((d,), ("feat",), init="zeros"),
        })
    specs.update({
        "final_w0": ParamSpec((d, d // 2), ("feat", None)),
        "final_b0": ParamSpec((d // 2,), (None,), init="zeros"),
        "final_w1": ParamSpec((d // 2, 1), (None, None)),
        "final_b1": ParamSpec((1,), (None,), init="zeros"),
    })
    return specs


def forward(params, batch: GraphBatch, cfg: DimeNetConfig,
            ctx: ShardCtx = NULL_CTX):
    if batch.trip_kj is None:
        raise ValueError("dimenet needs triplet lists (trip_kj, trip_ji)")
    N = batch.n_node
    E = batch.senders.shape[0]
    rij, d, emask = edge_vectors(batch)
    rbf = bessel_rbf(d, cfg.n_radial, cfg.cutoff) * \
        cosine_cutoff(d, cfg.cutoff)[:, None] * emask[:, None]
    rbf = ctx.constrain(rbf, "edges", None)
    snd, rcv = batch.senders.long(), batch.receivers.long()

    # ---- joint 2D basis on triplets ------------------------------------
    kj, ji = batch.trip_kj.long(), batch.trip_ji.long()
    kj_s, ji_s = torch.clamp(kj, max=E - 1), torch.clamp(ji, max=E - 1)
    tmask = (kj < E) & (ji < E)
    a = -rij[kj_s]                                  # j -> k
    b = rij[ji_s]                                   # j -> i
    cosang = torch.sum(a * b, -1) / torch.clamp(norm(a) * norm(b), min=1e-9)
    cosang = torch.clamp(cosang, -1.0, 1.0)
    roots = torch.as_tensor(spherical_bessel_roots(cfg.n_spherical,
                                                   cfg.n_radial),
                            dtype=torch.float32, device=d.device)  # (L, R)
    d_kj = d[kj_s]

    def basis(d_kj, cosang, tmask):
        # per-l evaluation keeps every transient at (T, R)
        jls = []
        for l in range(cfg.n_spherical):
            x = roots[l][None, :] * (d_kj / cfg.cutoff)[:, None]  # (T, R)
            jls.append(spherical_jn(l, x)[..., l])
        jl = torch.stack(jls, dim=1)                # (T, L, R)
        pl = legendre(cfg.n_spherical - 1, cosang)  # (T, L)
        sbf = (jl * pl[:, :, None]).reshape(-1, cfg.n_spherical *
                                            cfg.n_radial)
        return sbf.masked_fill_(~tmask[:, None], 0.0)
    # a triplet's basis is its own: on DTensors each rank makes its rows'
    sbf = rowwise(basis, d_kj, cosang, tmask) \
        if isinstance(d_kj, DTensor) else basis(d_kj, cosang, tmask)
    sbf = ctx.constrain(sbf, "edges", None)

    # ---- embedding block ------------------------------------------------
    h = params["embed"][batch.species.long()]
    e_rbf = rbf @ params["emb_rbf_w"]
    m = torch.cat([h[snd], h[rcv], e_rbf], dim=-1)
    m = F.silu(m @ params["emb_w"] + params["emb_b"])       # (E, d)
    m = ctx.constrain(m, "edges", None)

    energy = 0.0
    seg = torch.where(tmask, ji_s, E)
    for i in range(cfg.n_blocks):
        # directional aggregation over triplets (bilinear, low-rank),
        # down-projected before the triplet gather as in the reference
        u_e = (m * (rbf @ params[f"b{i}_rbf_w"])) @ params[f"b{i}_down"]
        u_e = ctx.constrain(u_e, "edges", None)               # (E, nb)
        u = u_e[kj_s]
        s = sbf @ params[f"b{i}_sbf_w"]                       # (T, nb)
        t = ctx.constrain((u * s).masked_fill_(~tmask[:, None], 0.0),
                          "edges", None)
        agg = scatter_sum(t, seg, E + 1)[:E]
        agg = ctx.constrain(agg, "edges", None)
        m2 = agg @ params[f"b{i}_up"]
        m = F.silu(m @ params[f"b{i}_msg_w"] + params[f"b{i}_msg_b"]) + m2
        m = m + F.silu(m @ params[f"b{i}_res_w"] + params[f"b{i}_res_b"])
        m = ctx.constrain(m, "edges", None)
        # output block: edges -> nodes
        o = (m * (rbf @ params[f"b{i}_out_rbf"]))
        o = ctx.constrain(o, "edges", None)
        node = ctx.constrain(scatter_sum(o, rcv, N), "nodes", None)
        node = F.silu(node @ params[f"b{i}_out_w"] + params[f"b{i}_out_b"])
        e_atom = F.silu(node @ params["final_w0"] + params["final_b0"])
        e_atom = e_atom @ params["final_w1"] + params["final_b1"]
        energy = energy + graph_energy(e_atom, batch)
    return energy


def loss_fn(params, batch: GraphBatch, cfg: DimeNetConfig,
            ctx: ShardCtx = NULL_CTX):
    energies = forward(params, batch, cfg, ctx)
    return torch.mean(torch.square(energies - batch.labels))
