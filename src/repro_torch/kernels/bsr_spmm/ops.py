"""Host-side BSR construction + graph aggregation through ``bsr_spmm``.

``graph_to_bsr`` gives the JAX package's ``repro/kernels/bsr_spmm/ops.py::
graph_to_bsr`` arrays bit for bit; only its per-block Python loop (each
block's slot within its row) is one vectorised expression. ``spmm`` does
not pad F to the TPU's 128 lanes: the kernel takes any F.

The dense blocks cost ``RB * nnz_per_row * BS^2 * 4`` bytes, which a graph
whose ids are not ordered by locality blows up (rgg2d at 2^20 would need
541 GiB); ``spmm`` states that size and raises before it allocates
anything that does not fit.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ...graphs.format import Graph
from ..dispatch import resolve_device
from .bsr_spmm import bsr_spmm


def _blocks(g: Graph, bs: int):
    """``(rb, nnz_per_row, key, uniq)``: the block rows, the most nonzero
    blocks in one of them, each arc's block key and the sorted keys of
    the nonzero blocks."""
    rb = -(-g.n // bs)
    # int64: rb * rb passes 2^31 beyond 5.9 M vertices at bs = 128
    key = (g.arc_tails().astype(np.int64) // bs) * rb \
        + np.asarray(g.adjncy, dtype=np.int64) // bs
    uniq = np.unique(key)
    per_row = np.bincount((uniq // rb).astype(np.int64), minlength=rb)
    nnz_per_row = max(1, int(per_row.max())) if rb else 1
    return rb, nnz_per_row, key, uniq


def _fill(g: Graph, bs: int, rb: int, nnz_per_row: int, key, uniq
          ) -> Tuple[np.ndarray, np.ndarray]:
    """``(col_flat, vals)`` of the padded layout."""
    blk_r = (uniq // rb).astype(np.int64)
    blk_c = (uniq % rb).astype(np.int64)
    col_flat = np.zeros(rb * nnz_per_row, dtype=np.int32)
    vals = np.zeros((rb * nnz_per_row, bs, bs), dtype=np.float32)
    blk_of_edge = np.searchsorted(uniq, key)
    # block b's slot within its row: b minus the row's first block (the
    # keys are sorted, so each row's blocks are contiguous)
    slot_within = np.arange(uniq.size, dtype=np.int64) - \
        np.searchsorted(blk_r, blk_r, side="left")
    flat_slot = blk_r * nnz_per_row + slot_within
    col_flat[flat_slot] = blk_c
    e_slot = flat_slot[blk_of_edge]
    np.add.at(vals, (e_slot, g.arc_tails() % bs, np.asarray(g.adjncy) % bs),
              g.eweights.astype(np.float32))
    return col_flat, vals


def graph_to_bsr(g: Graph, bs: int = 128
                 ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Adjacency (with edge weights) -> padded BSR.

    Returns (col_flat, vals, block_rows, nnz_per_row)."""
    rb, nnz, key, uniq = _blocks(g, bs)
    col_flat, vals = _fill(g, bs, rb, nnz, key, uniq)
    return col_flat, vals, rb, nnz


def _free_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def spmm(g: Graph, x: np.ndarray, bs: int = 128, device=None) -> np.ndarray:
    """Y[v] = sum_u w(v,u) * X[u] via the BSR kernel on ``device``
    (default: the CUDA device; ``"cpu"`` runs the plain version)."""
    dev = resolve_device(device)
    rb, nnz, key, uniq = _blocks(g, bs)
    need = rb * nnz * bs * bs * 4
    free = _free_bytes(dev)
    if need > free:
        raise MemoryError(
            f"spmm: the BSR blocks need {need} bytes ({rb} block rows x "
            f"{nnz} slots of {bs}x{bs} f32) and {dev} has {free} free")
    col_flat, vals = _fill(g, bs, rb, nnz, key, uniq)
    f = x.shape[1]
    xp = torch.zeros(rb * bs, f, dtype=torch.float32, device=dev)
    xp[:g.n] = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
    y = bsr_spmm(torch.from_numpy(col_flat).to(dev),
                 torch.from_numpy(vals).to(dev), xp, block_rows=rb,
                 nnz_per_row=nnz)
    return y[:g.n].cpu().numpy()
