"""Serving-tier metrics: counters, latency percentiles, queue depth — a
copy of the JAX package's ``serve/metrics.py`` (jax-free).

One :class:`ServeMetrics` per server, updated from the dispatcher and
every worker thread, snapshotted into plain dicts. Latencies keep a
bounded sample (admission -> resolution, i.e. queue wait plus every
attempt) so p50/p99 stay O(1) memory under sustained load; queue depth
is sampled at every admission and dispatch, giving the
depth-vs-offered-load curve the serve benchmark tracks.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

_MAX_SAMPLES = 8192


def percentile(sorted_xs: List[float], p: float) -> float:
    """Nearest-rank percentile of an already-sorted sample (0 when
    empty) — enough fidelity for serving dashboards, no numpy needed
    on the hot path.

    Nearest-rank is the value at 1-indexed rank ``ceil(p/100 * n)``.
    The old ``int(round(p/100 * (n-1)))`` form used banker's rounding,
    which on small samples (n < 100 — the CI bench regime) selects a
    *lower* rank than the definition and under-reports tail latency."""
    if not sorted_xs:
        return 0.0
    n = len(sorted_xs)
    idx = max(0, math.ceil(p / 100.0 * n) - 1)
    return sorted_xs[min(n - 1, idx)]


class ServeMetrics:
    """Thread-safe counters + bounded reservoirs for one server."""

    _COUNTERS = ("submitted", "completed", "failed", "expired",
                 "rejected", "retried", "batches", "coalesced",
                 "downgraded")

    def __init__(self, num_workers: int):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0  # resolved ok
        self.failed = 0  # resolved with a structured error
        self.expired = 0  # failed specifically on the deadline
        self.rejected = 0  # refused at admission (queue full/closed)
        self.retried = 0  # attempts re-routed to another mesh
        self.batches = 0  # multi-ticket attempts dispatched
        self.coalesced = 0  # tickets served off another ticket's run
        self.downgraded = 0  # quality="best" dropped to "fast" (deadline)
        self.batch_size_max = 0
        self.per_worker_served = [0] * num_workers
        self._latencies: List[float] = []
        self._queue_waits: List[float] = []
        self._depth_samples: List[int] = []
        # windowed state: counter values at the last snapshot_window()
        # call plus since-then reservoirs, so consumers (autoscaler,
        # front door health) see *rates*, not lifetime totals
        self._win_base: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        self._win_latencies: List[float] = []
        self._win_waits: List[float] = []
        self._win_depths: List[int] = []

    def resize_workers(self, num_workers: int) -> None:
        """Grow ``per_worker_served`` when the worker/server count
        changes at runtime (autoscaling). Growth only — counts for
        departed workers are history, not garbage."""
        with self._lock:
            if num_workers > len(self.per_worker_served):
                self.per_worker_served.extend(
                    [0] * (num_workers - len(self.per_worker_served)))

    # -- recording (called by server/dispatcher/workers) ---------------

    def on_submit(self, depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self._sample(self._depth_samples, depth)
            self._sample(self._win_depths, depth)

    def on_dispatch(self, depth: int) -> None:
        with self._lock:
            self._sample(self._depth_samples, depth)
            self._sample(self._win_depths, depth)

    def on_retry(self) -> None:
        with self._lock:
            self.retried += 1

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def on_downgrade(self) -> None:
        with self._lock:
            self.downgraded += 1

    def on_batch(self, size: int, distinct: int) -> None:
        """One multi-ticket attempt: ``size`` tickets ran as one batch,
        of which only ``distinct`` needed their own partition run."""
        with self._lock:
            self.batches += 1
            self.coalesced += max(0, size - distinct)
            self.batch_size_max = max(self.batch_size_max, size)

    def on_done(
        self,
        ok: bool,
        latency_s: float,
        queue_wait_s: float,
        worker: Optional[int],
        expired: bool = False,
    ) -> None:
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1
                if expired:
                    self.expired += 1
            if worker is not None and worker >= 0:
                # auto-grow: the fabric front door indexes servers that
                # join at runtime, so a fixed-size list would drop them
                if worker >= len(self.per_worker_served):
                    self.per_worker_served.extend(
                        [0] * (worker + 1 - len(self.per_worker_served)))
                self.per_worker_served[worker] += 1
            self._sample(self._latencies, latency_s)
            self._sample(self._queue_waits, queue_wait_s)
            self._sample(self._win_latencies, latency_s)
            self._sample(self._win_waits, queue_wait_s)

    def _sample(self, reservoir: list, x) -> None:
        if len(reservoir) >= _MAX_SAMPLES:
            # drop the oldest half: cheap, keeps recent behaviour
            del reservoir[: _MAX_SAMPLES // 2]
        reservoir.append(x)

    # -- reading -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        # one lock span: counters and reservoirs must come from the
        # same instant, or completed=N could pair with N-1 samples
        with self._lock:
            lat = sorted(self._latencies)
            wait = sorted(self._queue_waits)
            depth = list(self._depth_samples)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "expired": self.expired,
                "rejected": self.rejected,
                "retried": self.retried,
                "batches": self.batches,
                "coalesced": self.coalesced,
                "downgraded": self.downgraded,
                "batch_size_max": self.batch_size_max,
                "per_worker_served": list(self.per_worker_served),
            }
        mean_depth = sum(depth) / len(depth) if depth else 0.0
        out.update(
            {
                "latency_p50_s": round(percentile(lat, 50), 6),
                "latency_p99_s": round(percentile(lat, 99), 6),
                "queue_wait_p50_s": round(percentile(wait, 50), 6),
                "queue_wait_p99_s": round(percentile(wait, 99), 6),
                "queue_depth_max": max(depth, default=0),
                "queue_depth_mean": round(mean_depth, 3),
            }
        )
        return out

    def snapshot_window(self) -> Dict[str, object]:
        """Deltas since the last ``snapshot_window()`` call (rates, not
        lifetime totals): counter increments, latency/queue-wait
        percentiles over the window's own samples, and the window's
        queue-depth profile. Resets the window — callers own the
        cadence (the autoscaler's evaluation period, a fabric worker's
        heartbeat). First call returns everything since construction."""
        with self._lock:
            counts = {k: getattr(self, k) for k in self._COUNTERS}
            out: Dict[str, object] = {
                k: counts[k] - self._win_base[k] for k in self._COUNTERS
            }
            self._win_base = counts
            lat = sorted(self._win_latencies)
            wait = sorted(self._win_waits)
            depth = self._win_depths
            out.update(
                {
                    "latency_p50_s": round(percentile(lat, 50), 6),
                    "latency_p99_s": round(percentile(lat, 99), 6),
                    "queue_wait_p99_s": round(percentile(wait, 99), 6),
                    "queue_depth_max": max(depth, default=0),
                    "queue_depth_mean": round(
                        sum(depth) / len(depth), 3) if depth else 0.0,
                    "queue_depth_last": depth[-1] if depth else 0,
                }
            )
            self._win_latencies = []
            self._win_waits = []
            self._win_depths = []
            return out
