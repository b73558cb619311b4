"""GNN substrate: padded graph batches + segment-op message passing —
port of ``repro.models.gnn.common``.

Message passing runs over edge-index arrays: ``jax.ops.segment_sum`` /
``segment_max`` become ``index_add_`` / ``scatter_reduce_(..., "amax")``.
On a card both are atomics, whose float sums come out in no fixed order:
a forward there agrees with the CPU's within a tolerance, not bit for
bit. Padded edges use ``n_node - 1`` (the sentinel slot) as sender and
receiver, so gathers stay in bounds and scatters land in a junk slot.

On DTensors (the split layouts) ``scatter_sum`` adds each rank's own
rows into a whole local output, which is a partial sum over the mesh
dims the rows are split on (the next constraint reduces it, as GSPMD's
scatter does); ``segment_max``, whose ``scatter_reduce_`` has no
DTensor rule, replicates its operands and takes the max on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ...dist.sharding import contiguous_stride, to_placements

from ...graphs.format import Graph
from ...kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Static-shape batch. senders/receivers padded with n_node - 1."""
    senders: torch.Tensor       # (E,) int32
    receivers: torch.Tensor     # (E,) int32
    n_node: int                 # includes one sentinel slot at n
    node_feat: Optional[torch.Tensor] = None   # (N, F)
    species: Optional[torch.Tensor] = None     # (N,) int atomic numbers
    positions: Optional[torch.Tensor] = None   # (N, 3)
    graph_id: Optional[torch.Tensor] = None    # (N,) int32 for batched graphs
    n_graphs: int = 1
    labels: Optional[torch.Tensor] = None
    node_mask: Optional[torch.Tensor] = None   # (N,) bool
    # dimenet triplets: edge ids (kj, ji) with shared middle vertex j
    trip_kj: Optional[torch.Tensor] = None     # (T,) int32 (sentinel E)
    trip_ji: Optional[torch.Tensor] = None     # (T,) int32


def from_graph(g: Graph, feat=None, labels=None, seed: int = 0,
               with_positions: bool = False, pad_edges: int = 0,
               device=None) -> GraphBatch:
    """A ``GraphBatch`` of ``g``'s arcs (plus ``pad_edges`` sentinel
    edges) on ``device`` (the card by default); positions, when asked
    for, from ``seed`` as the reference draws them."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = g.arc_tails().astype(np.int32)
    dst = np.asarray(g.adjncy, dtype=np.int32)
    E = g.m + pad_edges
    senders = np.full(E, g.n, dtype=np.int32)
    receivers = np.full(E, g.n, dtype=np.int32)
    senders[:g.m] = src
    receivers[:g.m] = dst
    pos = rng.standard_normal((g.n + 1, 3)).astype(np.float32) * 2.0 \
        if with_positions else None

    def dev(x):
        return None if x is None else torch.as_tensor(np.asarray(x),
                                                      device=device)
    return GraphBatch(senders=dev(senders), receivers=dev(receivers),
                      n_node=g.n + 1, node_feat=dev(feat),
                      positions=dev(pos), species=None, labels=dev(labels))


def scatter_sum(values, index, num_segments: int):
    """``jax.ops.segment_sum``: rows of ``values`` summed by ``index``;
    an index outside [0, num_segments) is dropped (it lands in a junk
    slot past the end, with no host sync)."""
    if isinstance(values, DTensor) or isinstance(index, DTensor):
        return _split_scatter_sum(values, index, num_segments)
    index = index.long()
    keep = (index >= 0) & (index < num_segments)
    index = torch.where(keep, index, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, index, values)[:num_segments]


def _split_scatter_sum(values, index, num_segments: int):
    mesh = (values if isinstance(values, DTensor) else index).device_mesh
    values = to_placements(values, mesh, values.placements
                           if isinstance(values, DTensor)
                           else (Replicate(),) * mesh.ndim)
    rows = tuple(p if p.is_shard(0) else Replicate()
                 for p in values.placements)
    idx = to_placements(index, mesh, rows).to_local()
    out = scatter_sum(values.to_local(), idx, num_segments)
    placed = tuple(Partial() if p.is_shard(0) else p
                   for p in values.placements)
    shape = (num_segments,) + tuple(values.shape[1:])
    return DTensor.from_local(out, mesh, placed, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _expand_index(index, like):
    return index.long().reshape((-1,) + (1,) * (like.dim() - 1)) \
        .expand_as(like)


def segment_max(values, index, num_segments: int):
    """``jax.ops.segment_max`` over in-range indices: an empty segment
    is -inf, as the reference's identity."""
    if isinstance(values, DTensor) or isinstance(index, DTensor):
        mesh = (values if isinstance(values, DTensor) else index).device_mesh
        rep = (Replicate(),) * mesh.ndim
        out = segment_max(to_placements(values, mesh, rep).to_local(),
                          to_placements(index, mesh, rep).to_local(),
                          num_segments)
        return DTensor.from_local(out, mesh, rep, run_check=False)
    out = values.new_full((num_segments,) + tuple(values.shape[1:]),
                          -math.inf)
    return out.scatter_reduce_(0, _expand_index(index, values), values,
                               reduce="amax", include_self=True)


def edge_softmax(scores, receivers, n_node: int):
    """Per-destination softmax over incoming edges. scores: (E, ...)"""
    rcv = receivers.long()
    smax = segment_max(scores, rcv, n_node)
    ex = torch.exp(scores - smax[rcv])
    denom = scatter_sum(ex, rcv, n_node)
    return ex / torch.clamp(denom[rcv], min=1e-9)


def graph_energy(e_atom, batch: GraphBatch):
    """Per-graph sums of the (N, 1) atom energies of masked-in nodes
    (one graph, every node, where the batch leaves them out)."""
    N, dev = batch.n_node, e_atom.device
    gid = batch.graph_id if batch.graph_id is not None else \
        torch.zeros(N, dtype=torch.int32, device=dev)
    if batch.node_mask is not None:
        e_atom = torch.where(batch.node_mask[:, None], e_atom,
                             torch.zeros((), dtype=e_atom.dtype, device=dev))
    return scatter_sum(e_atom[:, 0], gid, batch.n_graphs)


def norm(x):
    """``jnp.linalg.norm(x, axis=-1)``: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def edge_vectors(batch: GraphBatch):
    """r_ij = pos[receiver] - pos[sender]; sentinel edges get unit z."""
    snd, rcv = batch.senders.long(), batch.receivers.long()
    rij = batch.positions[rcv] - batch.positions[snd]
    pad = batch.senders >= batch.n_node - 1
    unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=rij.dtype,
                          device=rij.device)
    rij = torch.where(pad[:, None], unit_z, rij)
    d = torch.clamp(norm(rij), min=1e-6)
    return rij, d, ~pad


def linspace(start: float, stop: float, num: int, device=None):
    """``jnp.linspace`` in float32 as XLA computes it: start * (1 - t) +
    stop * t with t = i / (num - 1), the division folded into a product
    with the f32 reciprocal (i * (stop * r)), and ``stop`` itself last.
    ``torch.linspace`` rounds another way, differing in the last ulp in
    most entries, which the gaussian basis's exp(-gamma (d - mu)^2)
    amplifies ~20-fold at 300 bases."""
    f32 = torch.float32
    if num == 1:
        return torch.full((1,), start, dtype=f32, device=device)
    r = torch.tensor(1.0, dtype=f32) / torch.tensor(num - 1, dtype=f32)
    i = torch.arange(num - 1, dtype=f32, device=device)
    lo = torch.tensor(start, dtype=f32)
    hi = torch.tensor(stop, dtype=f32)
    out = lo * (1 - i * r) + i * (hi * r)
    return torch.cat([out, hi[None].to(device)])


def gaussian_rbf(d, n_rbf: int, cutoff: float):
    mu = linspace(0.0, cutoff, n_rbf, device=d.device)
    gamma = 1.0 / ((mu[1] - mu[0]) ** 2 + 1e-9)
    return torch.exp(-gamma * torch.square(d[:, None] - mu[None, :]))


def bessel_rbf(d, n_rbf: int, cutoff: float):
    """DimeNet/NequIP radial basis: sqrt(2/c) sin(n pi d / c) / d."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    c = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32,
                                device=d.device))
    return (c * torch.sin(n[None, :] * math.pi * d[:, None] / cutoff)
            / d[:, None])


def cosine_cutoff(d, cutoff: float):
    c = 0.5 * (torch.cos(math.pi * torch.clamp(d, max=cutoff) / cutoff)
               + 1.0)
    return torch.where(d <= cutoff, c, torch.zeros((), dtype=c.dtype,
                                                   device=c.device))
