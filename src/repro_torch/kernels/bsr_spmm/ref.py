"""Plain-PyTorch version of the ``bsr_spmm`` CUDA kernel.

The JAX package's ``bsr_spmm_ref`` op for op: gather the X block of every
slot, one dense block product per slot, then the sum over each row's
slots. The kernel accumulates the same products in another order, in
error-compensated TF32 on the tensor cores (about f32's rounding; exact
f32 where a value is not finite), so the two agree within f32 rounding,
not bit for bit. On the card the products go through cuBLAS: run it with
``torch.backends.cuda.matmul.allow_tf32`` off, or TF32 makes this side
the inexact one. The wrapper runs it for CPU tensors; the chip check
holds the kernel to it.
"""
from __future__ import annotations

import torch


def bsr_spmm_ref(col_flat, vals, x, *, block_rows: int, nnz_per_row: int):
    """Y (block_rows * BS, F) f32 from col_flat (RB * NNZ,) int32, vals
    (RB * NNZ, BS, BS) f32 and x (CB * BS, F) f32."""
    bs = vals.shape[1]
    f = x.shape[1]
    xb = x.reshape(-1, bs, f)
    gathered = xb[col_flat.long()]                     # (RB*NNZ, BS, F)
    prod = torch.einsum("nij,njf->nif", vals, gathered)
    prod = prod.reshape(block_rows, nnz_per_row, bs, f).sum(1)
    return prod.reshape(block_rows * bs, f)
