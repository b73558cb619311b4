"""Server-location registry with heartbeat leases — port of
``repro.fabric.registry``.

The front door's source of truth for which ``PartitionServer``
processes are alive (a location service: servers announce
themselves and keep a lease warm; consumers only ever see the live
set). A worker ``register``s its address and shape, then ``renew``s its
lease every heartbeat, attaching a windowed ``ServeMetrics`` snapshot —
the health/pressure signal the autoscaler and the routing policy read.
A lease that misses renewals for ``ttl_s`` expires; the front door
treats expiry exactly like a dead connection (re-route-and-retry, the
in-process tier's failover semantics).

Pure bookkeeping: no sockets, injectable clock, fully unit-testable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class ServerRecord:
    """One registered ``PartitionServer`` process."""

    server_id: str
    host: str
    port: int
    devices: int = 1  # devices per worker mesh (routing fit)
    meshes: int = 1  # worker meshes -> concurrent capacity
    pid: Optional[int] = None
    lease_expiry: float = 0.0  # clock() time the lease lapses
    registered_t: float = 0.0
    renewals: int = 0
    generation: int = 0  # bumps when the same id re-registers
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out.pop("metrics", None)
        out["queue_depth"] = self.metrics.get("queue_depth_last", 0)
        out["expired_misses"] = self.metrics.get("expired", 0)
        # attempts running on the server's own meshes right now — lags
        # one heartbeat behind the front door's dispatch-side inflight
        out["worker_inflight"] = self.metrics.get("inflight", 0)
        return out


class ServerRegistry:
    """Thread-safe lease table keyed by server id.

    ``ttl_s`` is the lease length granted at register/renew time;
    workers heartbeat a few times per TTL so one dropped heartbeat
    doesn't flap the server out of rotation.
    """

    def __init__(
        self,
        ttl_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._records: Dict[str, ServerRecord] = {}

    # -- lease lifecycle -----------------------------------------------

    def register(
        self,
        server_id: str,
        host: str,
        port: int,
        *,
        devices: int = 1,
        meshes: int = 1,
        pid: Optional[int] = None,
    ) -> ServerRecord:
        """Admit (or re-admit) a server; returns the new record (its
        lease runs ``ttl_s`` from now).

        Re-registering an existing id replaces the record and bumps its
        ``generation`` — the restart marker the front door uses to drop
        state (connections, inflight counts) tied to the old process.
        """
        if not server_id:
            raise ValueError("server_id must be a non-empty string")
        now = self._clock()
        with self._lock:
            old = self._records.get(server_id)
            rec = ServerRecord(
                server_id=server_id,
                host=host,
                port=int(port),
                devices=int(devices),
                meshes=int(meshes),
                pid=pid,
                lease_expiry=now + self.ttl_s,
                registered_t=now,
                generation=(old.generation + 1) if old else 0,
            )
            self._records[server_id] = rec
        return rec

    def renew(
        self,
        server_id: str,
        metrics: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Extend a live lease; False when the id is unknown or already
        expired — the worker's cue to re-register (its old record may
        have been expired and its tickets already re-routed)."""
        now = self._clock()
        with self._lock:
            rec = self._records.get(server_id)
            if rec is None or rec.lease_expiry <= now:
                return False
            rec.lease_expiry = now + self.ttl_s
            rec.renewals += 1
            if metrics is not None:
                rec.metrics = dict(metrics)
            return True

    def deregister(self, server_id: str) -> Optional[ServerRecord]:
        """Graceful exit (drain finished) — no failover needed."""
        with self._lock:
            return self._records.pop(server_id, None)

    def expire(self, now: Optional[float] = None) -> List[ServerRecord]:
        """Remove and return every record whose lease has lapsed. The
        front door calls this on a timer and fails the dead servers'
        in-flight tickets over, exactly like a dropped connection."""
        now = self._clock() if now is None else now
        with self._lock:
            dead = [
                r for r in self._records.values() if r.lease_expiry <= now
            ]
            for r in dead:
                del self._records[r.server_id]
            return dead

    # -- reading -------------------------------------------------------

    def alive(self) -> List[ServerRecord]:
        """Live records (leases still warm), stable id order. Does not
        expire — the owner's expiry sweep does that, so the failover
        path runs in exactly one place."""
        now = self._clock()
        with self._lock:
            recs = sorted(self._records.items())
            return [r for _, r in recs if r.lease_expiry > now]

    def get(self, server_id: str) -> Optional[ServerRecord]:
        with self._lock:
            return self._records.get(server_id)

    def __len__(self) -> int:
        return len(self.alive())

    def snapshot(self) -> List[Dict[str, Any]]:
        """JSON-safe view of the live set (the ``status`` op payload)."""
        return [r.summary() for r in self.alive()]
