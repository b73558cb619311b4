"""Sparse all-to-all collectives (paper §3, Communication) — port of
``repro.dist.collectives`` onto ``torch.distributed``.

The reference runs its per-PE code under ``shard_map`` over a 1-D "pe"
mesh; here each PE is one rank of a process group, described by a
``PeGroup``: the group, this rank, P, the rank's device and (for grid
routing) its row and column subgroups. Every function below is called by
every rank of the group, in the same order, as the reference's per-PE
bodies call their ``lax`` collectives.

Both primitives transpose a per-PE message slab: each PE holds a local
array ``slab`` of shape (P, ...) where ``slab[q]`` is the message destined
for PE q; after the exchange PE p holds ``out[q] == slab_of_q[p]``.

``direct_all_to_all`` issues the single P-way collective. For large P the
paper routes the same payload through a two-level a x b grid
(``grid_all_to_all``): messages first travel within grid rows (grouped by
destination column), then within columns — 2·(a+b) partners per PE instead
of P, at the cost of forwarding each payload twice. Non-square P uses the
largest divisor a <= sqrt(P) (6 PEs -> 2x3); prime P degenerates to the
direct exchange.

On top of the raw transposition sit three protocol primitives:
``halo_exchange`` (ghost-vertex refresh over a static schedule),
``exchange_segments`` (segmented payload exchange for the distributed
contraction's edge shuffle, §5), and the owner-sharded weight-table pair
``all_gather_1d`` / ``psum_scatter_1d`` (read / commit halves of the
distributed cluster- and block-weight tables). Each routes either
directly or through the grid with identical results, and puts the same
slab in the same place as its ``lax`` counterpart (``tiled=True``).

A tensor handed to a collective must lie on the group's device (the CPU
for gloo, the rank's card for NCCL); any other raises ``ValueError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def grid_factors(P: int) -> Tuple[int, int]:
    """(a, b) with a*b == P, a <= b, a the largest divisor <= sqrt(P)."""
    a = 1
    d = 1
    while d * d <= P:
        if P % d == 0:
            a = d
        d += 1
    return a, P // a


class PeGroup:
    """The SPMD stand-in for the reference's 1-D "pe" mesh: the default
    process group (one rank a PE), this rank, P and the rank's device.

    ``grid()`` creates the row and column subgroups of the a x b grid the
    first time grid routing needs them; ``new_group`` is collective, so
    every rank reaches that call in the same order (the engine's host code
    runs the same path on every rank). ``collectives`` counts the
    ``torch.distributed`` calls this group made."""

    def __init__(self, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "PeGroup: torch.distributed is not initialised; call "
                "repro_torch.api.runtime.distributed_init first")
        self.group = group
        self.P = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.collectives = 0
        self._grid: Optional[Tuple[int, int, object, object]] = None

    def grid(self):
        """``(a, b, row_group, col_group)``: this rank's grid row and
        column subgroups (PE p sits at (p // b, p % b))."""
        if self._grid is None:
            a, b = grid_factors(self.P)
            mine_r = mine_c = None
            if a > 1:
                for r in range(a):      # every rank, the same order
                    g = dist.new_group([r * b + c for c in range(b)])
                    if r == self.rank // b:
                        mine_r = g
                for c in range(b):
                    g = dist.new_group([r * b + c for r in range(a)])
                    if c == self.rank % b:
                        mine_c = g
            self._grid = (a, b, mine_r, mine_c)
        return self._grid

    def check(self, t: torch.Tensor, what: str) -> None:
        if t.device != self.device:
            raise ValueError(
                f"{what}: a tensor on {t.device} handed to a collective of "
                f"a group on {self.device}")


_WORLD: List[PeGroup] = []

# torch 2.13 renamed the two tensor collectives (the old names warn)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def world_group(device=None) -> PeGroup:
    """The ``PeGroup`` of the initialised default group, one a process
    (its grid subgroups are made once). ``device`` defaults to the rank's
    card under NCCL and the CPU under gloo."""
    if _WORLD and dist.is_initialized() and \
            _WORLD[0].P == dist.get_world_size():
        pe = _WORLD[0]
        if device is None or torch.device(device) == pe.device:
            return pe
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    _WORLD[:] = [PeGroup(device)]
    return _WORLD[0]


def forget_world_group() -> None:
    """Drop the cached ``PeGroup`` (before the default group is
    destroyed)."""
    _WORLD.clear()


# the static verifier's collective log (``analysis/collectives_pass.py``)
# while it tapes an entry: called as ``OBSERVER(kind, tensor, group, pe)``
# before each collective below is issued, and None otherwise
OBSERVER = None


def _issue(kind: str, x: torch.Tensor, pe: PeGroup, group) -> None:
    pe.collectives += 1
    if OBSERVER is not None:
        OBSERVER(kind, x, group, pe)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (gloo has no bool reductions)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _a2a(x: torch.Tensor, pe: PeGroup, group) -> torch.Tensor:
    out = torch.empty_like(x)
    _issue("all_to_all", x, pe, group)
    dist.all_to_all_single(out, x, group=group)
    return out


def direct_all_to_all(slab: torch.Tensor, pe: PeGroup) -> torch.Tensor:
    """One-phase transposition along axis 0: out[q] = slab_of_q[p]."""
    pe.check(slab, "direct_all_to_all")
    x = _wire(slab)
    out = _a2a(x, pe, pe.group)
    return out.to(torch.bool) if slab.dtype == torch.bool else out


def grid_all_to_all(slab: torch.Tensor, pe: PeGroup) -> torch.Tensor:
    """Two-level all-to-all through an a x b PE grid (PE p = (p//b, p%b)).

    Phase 1 transposes within grid rows over the destination-column axis;
    phase 2 within grid columns over the destination-row axis. The result
    is bit-identical to ``direct_all_to_all``."""
    a, b, row_g, col_g = pe.grid()
    if a == 1:  # prime P: no nontrivial grid, route directly
        return direct_all_to_all(slab, pe)
    pe.check(slab, "grid_all_to_all")
    tail = slab.shape[1:]
    m = _wire(slab).reshape((a, b) + tail)           # [dst_row, dst_col]
    m = _a2a(m.transpose(0, 1).contiguous(), pe, row_g)
    m = m.transpose(0, 1).contiguous()               # [dst_row, src_col]
    m = _a2a(m, pe, col_g)                           # [src_row, src_col]
    m = m.reshape((pe.P,) + tail)
    return m.to(torch.bool) if slab.dtype == torch.bool else m


def all_to_all(slab: torch.Tensor, pe: PeGroup,
               use_grid: bool = False) -> torch.Tensor:
    return grid_all_to_all(slab, pe) if use_grid \
        else direct_all_to_all(slab, pe)


def _gather(x: torch.Tensor, pe: PeGroup, group, parts: int):
    out = torch.empty((parts * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _issue("all_gather", x, pe, group)
    _ALL_GATHER(out, x, group=group)
    return out


def all_gather_1d(shard: torch.Tensor, pe: PeGroup,
                  use_grid: bool = False) -> torch.Tensor:
    """Concatenate the (S, ...) owner shards of all P PEs along the
    leading axis into the dense (P*S, ...) table (every PE receives the
    same array).

    The read half of the owner-sharded weight protocol, and the pool
    combiner of the distributed balancer. Grid routing gathers within grid
    rows, then columns — bit-identical to the direct gather."""
    pe.check(shard, "all_gather_1d")
    x = _wire(shard)
    if use_grid:
        a, b, row_g, col_g = pe.grid()
    if not use_grid or a == 1:
        out = _gather(x, pe, pe.group, pe.P)
    else:
        out = _gather(_gather(x, pe, row_g, b), pe, col_g, a)
    return out.to(torch.bool) if shard.dtype == torch.bool else out


def _scatter(x: torch.Tensor, pe: PeGroup, group, parts: int):
    out = torch.empty((x.shape[0] // parts,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _issue("reduce_scatter", x, pe, group)
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def psum_scatter_1d(dense: torch.Tensor, pe: PeGroup,
                    use_grid: bool = False) -> torch.Tensor:
    """Reduce-scatter a dense (P*S,) delta table to owner shards: PE p
    receives sum_q dense_of_q[p*S:(p+1)*S].

    The commit half of the owner-sharded weight protocol. Integer payloads
    make grid and direct routing bit-identical."""
    pe.check(dense, "psum_scatter_1d")
    x = dense.contiguous()
    if use_grid:
        a, b, row_g, col_g = pe.grid()
    if not use_grid or a == 1:
        return _scatter(x, pe, pe.group, pe.P)
    # phase 1: sum within grid columns, each PE keeping its dst-row block;
    # phase 2: sum within grid rows, each PE keeping its dst-column block
    return _scatter(_scatter(x, pe, col_g, a), pe, row_g, b)


def psum(x: torch.Tensor, pe: PeGroup) -> torch.Tensor:
    """``lax.psum`` over the group: the elementwise sum of every PE's
    ``x``, on every PE."""
    pe.check(x, "psum")
    out = x.clone()
    _issue("psum", x, pe, pe.group)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=pe.group)
    return out


def exchange_segments(slab: torch.Tensor, counts: torch.Tensor,
                      pe: PeGroup, use_grid: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented all-to-all: transpose a (P, S, ...) payload slab together
    with its per-destination segment lengths (P,).

    After the exchange PE p holds ``recv[q] = slab_of_q[p]`` with
    ``recv_counts[q]`` valid rows — the edge-exchange primitive of the
    distributed contraction (paper §5)."""
    recv = all_to_all(slab, pe, use_grid=use_grid)
    rcounts = all_to_all(counts.reshape(pe.P, 1), pe,
                         use_grid=use_grid).reshape(pe.P)
    return recv, rcounts


def halo_exchange(vals: torch.Tensor, send_idx: torch.Tensor,
                  recv_slot: torch.Tensor, n_ghost: int, pe: PeGroup,
                  use_grid: bool = False) -> torch.Tensor:
    """Ghost-vertex value exchange over a ``GraphShards`` halo plan.

    ``vals``: (n_loc,) values of this PE's owned vertices.
    ``send_idx``/``recv_slot``: this PE's (P, S) rows of the static halo
    schedule (sentinels n_loc / n_ghost mark padding).
    Returns the (n_ghost,) ghost values; padded ghost slots read 0."""
    pad = torch.cat([vals, vals.new_zeros(1)])
    msg = pad[send_idx.long()]                             # (P, S)
    rcv = all_to_all(msg, pe, use_grid=use_grid)
    out = vals.new_zeros(n_ghost + 1)
    # the sentinel slot n_ghost collects the padding and is cut off
    out[recv_slot.reshape(-1).long()] = rcv.reshape(-1)
    return out[:n_ghost]
