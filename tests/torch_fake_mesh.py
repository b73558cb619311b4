"""A ``DeviceMesh`` over a ``"fake"`` process group (a helper of the
port's sharding tests): this process is rank 0 of ``prod(shape)`` ranks
that do not exist, every collective a no-op. A plain tensor laid out on
it keeps rank 0's own piece, so local values are checkable; a gather's
other pieces are not."""
from __future__ import annotations

import contextlib
import math


@contextlib.contextmanager
def fake_mesh(shape, names):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape),
                         mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()
