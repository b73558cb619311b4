"""Wrapper of the ``bsr_spmm`` CUDA kernel (``csrc/bsr_spmm.cu``).

``Y = A X`` with A in padded block-sparse-row form: the hand-written
Hopper port of the JAX package's Pallas kernel ``repro/kernels/bsr_spmm/
bsr_spmm.py::bsr_spmm``. A CPU tensor runs the plain version (``ref``); a
CUDA tensor launches the kernel or raises. Unlike the TPU kernel it takes
any F (no padding to 128 lanes) and any block size up to 128. The kernel
multiplies in error-compensated TF32 on the tensor cores, exact f32 where
a value does not split, and skips all-zero 16 x 8 sub-tiles of A.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import bsr_spmm_ref

_SIG = {"bsr_spmm": [_build.P] * 3 + [_build.I] * 4 + [_build.P] * 2}

MAX_BS = 128        # the kernel's Y tile holds 128 rows


def bsr_spmm(col_flat, vals, x, *, block_rows: int, nnz_per_row: int):
    """col_flat: (block_rows * nnz_per_row,) int32 column-block ids
    (padded entries point at block 0 with all-zero vals). vals: same
    order, (block_rows * nnz_per_row, BS, BS) f32. x: (CB * BS, F) f32.
    Returns (block_rows * BS, F) f32. A column-block id outside [0, CB)
    raises."""
    nb, bs = vals.shape[0], vals.shape[1]
    f = x.shape[1]
    if x.shape[0] % bs:
        raise ValueError(f"bsr_spmm: x has {x.shape[0]} rows, not a "
                         f"multiple of the block size {bs}")
    cb = x.shape[0] // bs
    if vals.device.type == "cpu":
        _build.check_index_range("bsr_spmm col_flat", col_flat, cb)
        return bsr_spmm_ref(col_flat, vals, x, block_rows=block_rows,
                            nnz_per_row=nnz_per_row)
    if vals.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {vals.device}")
    dev = vals.device
    if nb != block_rows * nnz_per_row:
        raise ValueError(f"bsr_spmm: {nb} blocks for {block_rows} block "
                         f"rows x {nnz_per_row} slots")
    _build.require("bsr_spmm col_flat", col_flat, torch.int32, (nb,), dev)
    _build.require("bsr_spmm vals", vals, torch.float32, (nb, bs, bs), dev)
    _build.require("bsr_spmm x", x, torch.float32, (cb * bs, f), dev)
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"bsr_spmm: block size {bs} outside [1, "
                         f"{MAX_BS}]")
    if block_rows >= 2**31:
        raise ValueError(f"bsr_spmm: {block_rows} block rows exceed the "
                         "launch limit")
    _build.check_index_range("bsr_spmm col_flat", col_flat, cb)
    y = torch.empty(block_rows * bs, f, dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    return _launch(col_flat, vals, x, y, block_rows, nnz_per_row)


def _launch(col_flat, vals, x, y, block_rows: int, nnz_per_row: int):
    """Launch the kernel on operands ``bsr_spmm`` has checked, into ``y``:
    no check and no read-back, so a CUDA graph can capture it."""
    lib = _build.load("bsr_spmm", _SIG)
    p = _build.ptr
    err = lib.bsr_spmm(p(col_flat), p(vals), p(x), block_rows, nnz_per_row,
                       vals.shape[1], x.shape[1], p(y),
                       _build.stream_of(vals))
    _build.check(err, "bsr_spmm")
    _build.count_launch("bsr_spmm")
    return y
