"""Wrapper of the ``embedding_bag`` CUDA kernel (``csrc/embedding_bag.cu``).

Sum-pooled bags of table rows: the hand-written Hopper port of the JAX
package's Pallas kernel ``repro/kernels/embedding_bag/embedding_bag.py::
embedding_bag_1row``. A CPU tensor runs the plain version (``ref``); a
CUDA tensor launches the kernel or raises. An index outside [0, V)
raises on either device (the reference's ``jnp.take`` clamps it and its
DMA index map reads out of bounds, so there is no behaviour to match).
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import embedding_bag_ref

_SIG = {"embedding_bag": [_build.P] * 2 + [_build.I] * 4 + [_build.P] * 2}


def embedding_bag_1row(idx, table):
    """idx (B, BAG) int32, table (V, D) f32 -> (B, D) f32 sum-pooled;
    repeated indices are summed, not deduped. An index outside [0, V)
    raises ``ValueError``; on the card that check reads two numbers
    back, so it waits for the stream."""
    if table.device.type in ("cpu", "cuda"):    # _gather raises on others
        _build.check_index_range("embedding_bag idx", idx, table.shape[0])
    return _gather(idx, table)


def _gather(idx, table):
    """``embedding_bag_1row`` for indices already known to lie in
    [0, V): no check on the device and nothing read back. On the card an
    index outside stops the kernel (``__trap``) before it reads outside
    the table, which leaves the CUDA context unusable."""
    B, BAG = idx.shape
    V, D = table.shape
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_ref(idx, table)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {dev}")
    _build.require("embedding_bag idx", idx, torch.int32, (B, BAG), dev)
    _build.require("embedding_bag table", table, torch.float32, (V, D), dev)
    if B >= 2**31 or D >= 2**31 or V >= 2**31:
        raise ValueError(f"embedding_bag: {B} bags of width {D} from {V} "
                         "rows exceed the launch limits")
    out = torch.empty(B, D, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("embedding_bag", _SIG)
    p = _build.ptr
    err = lib.embedding_bag(p(idx), p(table), B, BAG, D, V, p(out),
                            _build.stream_of(table))
    _build.check(err, "embedding_bag")
    _build.count_launch("embedding_bag")
    return out
