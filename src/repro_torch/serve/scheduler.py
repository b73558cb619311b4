"""Mesh-routing policy for the serving tier — a copy of the JAX
package's ``serve/scheduler.py`` (pure, jax-free; kept here so the port
imports nothing of it).

The scheduler answers one question: given a ticket that needs ``need``
PEs (``api.backends.required_devices`` — the same pure policy
``backend="auto"`` uses), which live worker mesh should run it?

Ranking, best first:

1. exact PE-count match — the worker's shared mesh is reused directly;
2. smallest mesh with at least ``need`` PEs — the request still runs,
   leaving bigger meshes free for bigger jobs;
3. any remaining mesh — an undersized mesh can always serve a request
   without the shared mesh, so correctness never depends on fit;

ties broken by lighter load, then by worker id for determinism. The
policy is a pure function over (need, candidates) so it unit-tests
without a server or a device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

# a fit penalty larger than any realistic mesh-size gap, so undersized
# meshes always rank behind every mesh that actually fits
_UNDERSIZED = 1 << 20


def rank(
    need: int,
    devices: int,
    inflight: int,
    worker_id: int,
) -> Tuple[int, int, int, int]:
    """Sort key for one candidate mesh; lower is better."""
    exact = 0 if devices == need else 1
    if devices >= need:
        fit = devices - need
    else:
        fit = _UNDERSIZED + (need - devices)
    return (exact, fit, inflight, worker_id)


def pick_worker(need: int, candidates: Sequence) -> Optional[object]:
    """Best-fitting worker from ``candidates`` (objects exposing
    ``devices``, ``inflight`` and ``wid``), or None when empty."""
    best = None
    best_key = None
    for w in candidates:
        key = rank(need, w.devices, w.inflight, w.wid)
        if best_key is None or key < best_key:
            best, best_key = w, key
    return best


def pick_server(need: int, candidates: Sequence) -> Optional[object]:
    """Best-fitting fabric *server* from ``candidates`` (objects
    exposing ``devices``, ``inflight`` and a string ``sid``) — the same
    exact-match / smallest-fit / any ranking as :func:`pick_worker`,
    with the deterministic tiebreak on the server id string. Pure, so
    the cross-process front door routes with the in-process policy."""
    best = None
    best_key = None
    for s in candidates:
        key = rank(need, s.devices, s.inflight, 0)[:3] + (s.sid,)
        if best_key is None or key < best_key:
            best, best_key = s, key
    return best
