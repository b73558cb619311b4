"""The work plan of the heavy-row kernels (``lp_move_heavy``,
``bal_scores_heavy``): which heavy rows a warp takes and how the hub rows
are cut into lane ranges, one CTA each.

A heavy row has more arcs than the capped ELL slab holds: its D slab
lanes, then its overflow arcs (``lp_move.ops.Overflow``), L = D + its
overflow lanes in all. Rows of at most ``WARP_LANES`` lanes form the warp
class, one warp each, planned by the kernel itself (warp h takes heavy
row h and leaves a hub row alone). The other rows, the hubs, are laid
end to end in a hub-lane space; range c = [c HUB_RANGE, (c + 1)
HUB_RANGE) of it is one CTA's, whatever rows it crosses. The plan is
built once for each ELL build (``heavy_plan``, numpy) and rides in the
``Overflow``:

* ``hubs`` (n_hub + 1, 2) int32: hub row k's heavy index and its first
  lane in the hub-lane space; the last entry (H, HL), HL the hub lanes
  in all;
* ``ranges`` (G,) int32, G = ceil(HL / HUB_RANGE): the hub row that
  holds the first lane of range c.

``WARP_LANES`` and ``HUB_RANGE`` are the constants of
``csrc/common.cuh`` (a test holds the two equal). The plain versions
split a row's lanes the same way (``lane_items``) and sum the parts.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

WARP_LANES = 256    # a warp-class row's lanes at most
HUB_RANGE = 1024    # hub lanes a CTA takes


def heavy_plan(lanes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(hubs, ranges)`` of heavy rows of ``lanes`` lanes each (slab and
    overflow), as the module docstring lays them out."""
    lanes = np.asarray(lanes, dtype=np.int64)
    hub = np.flatnonzero(lanes > WARP_LANES)
    off = np.zeros(hub.size + 1, dtype=np.int64)
    np.cumsum(lanes[hub], out=off[1:])
    hubs = np.stack([np.append(hub, lanes.size), off], axis=1)
    G = -(-int(off[-1]) // HUB_RANGE)
    ranges = np.searchsorted(off, np.arange(G, dtype=np.int64) * HUB_RANGE,
                             side="right") - 1
    return hubs.astype(np.int32), ranges.astype(np.int32)


def lane_items(hid, pos, lanes):
    """The work item of each heavy lane (torch, on any device), as the
    kernels split the rows: lane ``pos`` of heavy row ``hid`` (of
    ``lanes[hid]`` lanes) is item ``hid`` in a warp-class row and item
    ``H + c`` in a hub row, c its hub range."""
    import torch

    H = lanes.shape[0]
    hub = lanes > WARP_LANES
    off = torch.cumsum(torch.where(hub, lanes, 0).long(), 0) \
        - torch.where(hub, lanes, 0).long()
    lane = off[hid] + pos
    return torch.where(hub[hid], H + lane // HUB_RANGE, hid.long())
