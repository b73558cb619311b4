"""Autoscaler: grow/shrink fabric worker processes from serve signals —
port of ``repro.fabric.autoscaler``.

Two layers, split so the policy is a pure unit-testable object:

* :class:`AutoscalePolicy` — consumes one observation per evaluation
  period (front-door queue depth, windowed deadline misses and submit
  counts — the signals ``ServeMetrics.snapshot_window`` already
  produces) and answers grow/hold/shrink with hysteresis: pressure must
  persist for ``grow_windows`` consecutive windows before growing, and
  the fabric must be idle for ``shrink_windows`` consecutive windows
  before shrinking, so a single burst or a single quiet beat never
  flaps the fleet. Bounds are hard: never below ``min_workers``, never
  above ``max_workers``.

* :class:`ProcessScaler` — owns the worker subprocesses the front door
  spawned (and only those: externally launched workers are never
  killed). Scale-up spawns one worker from the command template;
  scale-down SIGTERMs the youngest spawned worker, which drains
  gracefully (finishes in-flight, resolves queued tickets as
  ``server_closed``, deregisters) before exiting.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs of the policy (the grow and shrink thresholds below)."""

    min_workers: int = 1
    max_workers: int = 2
    # pressure: queued work per live server at/above which a window
    # counts as a breach; any windowed deadline miss is always a breach
    grow_queue_depth: float = 2.0
    grow_windows: int = 2  # consecutive breaches before growing
    shrink_windows: int = 4  # consecutive idle windows before shrinking
    eval_period_s: float = 0.5

    def validate(self) -> "AutoscaleConfig":
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}"
            )
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= "
                f"min_workers ({self.min_workers})"
            )
        if self.grow_windows < 1 or self.shrink_windows < 1:
            raise ValueError("grow_windows and shrink_windows must be >= 1")
        if self.eval_period_s <= 0:
            raise ValueError(
                f"eval_period_s must be > 0, got {self.eval_period_s}"
            )
        return self


class AutoscalePolicy:
    """Hysteresis-gated grow/hold/shrink decisions (pure)."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg.validate()
        self._pressure_streak = 0
        self._idle_streak = 0

    def observe(
        self,
        *,
        workers: int,
        queue_depth: int,
        deadline_misses: int = 0,
        submitted: int = 0,
        inflight: int = 0,
    ) -> int:
        """One evaluation window -> +1 (grow), -1 (shrink) or 0.

        ``workers`` is the count the decision is bounded against (the
        processes the scaler owns, including ones still starting up —
        bounding against *registered* servers would spawn a second
        worker while the first is still importing torch).
        """
        per = queue_depth / max(1, workers)
        pressure = per >= self.cfg.grow_queue_depth or deadline_misses > 0
        idle = queue_depth == 0 and submitted == 0 and inflight == 0
        self._pressure_streak = self._pressure_streak + 1 if pressure else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if (
            self._pressure_streak >= self.cfg.grow_windows
            and workers < self.cfg.max_workers
        ):
            self._pressure_streak = 0
            self._idle_streak = 0
            return 1
        if (
            self._idle_streak >= self.cfg.shrink_windows
            and workers > self.cfg.min_workers
        ):
            self._idle_streak = 0
            self._pressure_streak = 0
            return -1
        return 0


class ProcessScaler:
    """Spawn/stop fabric worker processes for the front door.

    ``worker_args`` is everything after ``repro_torch.launch.fabric
    worker``
    except ``--server-id`` (generated per spawn) — typically at least
    ``--frontdoor host:port``.
    """

    def __init__(
        self,
        worker_args: Sequence[str],
        env: Optional[Dict[str, str]] = None,
        id_prefix: str = "auto",
    ):
        self._worker_args = list(worker_args)
        self._env = dict(env) if env is not None else dict(os.environ)
        self._id_prefix = id_prefix
        self._lock = threading.Lock()
        self._procs: List[subprocess.Popen] = []
        self._spawned = 0

    def _reap_locked(self) -> None:
        self._procs = [p for p in self._procs if p.poll() is None]

    def count(self) -> int:
        """Live worker processes this scaler owns (spawned and not yet
        exited — a worker still importing torch counts)."""
        with self._lock:
            self._reap_locked()
            return len(self._procs)

    def scale_up(self) -> str:
        """Spawn one worker; returns its server id."""
        with self._lock:
            self._spawned += 1
            sid = f"{self._id_prefix}-{os.getpid()}-{self._spawned}"
            cmd = [
                sys.executable,
                "-m",
                "repro_torch.launch.fabric",
                "worker",
                "--server-id",
                sid,
            ]
            cmd += self._worker_args
            proc = subprocess.Popen(
                cmd,
                env=self._env,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            self._procs.append(proc)
            return sid

    def scale_down(self) -> Optional[int]:
        """SIGTERM the youngest spawned worker (graceful drain);
        returns its pid, or None when none are left."""
        with self._lock:
            self._reap_locked()
            if not self._procs:
                return None
            proc = self._procs[-1]
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            return proc.pid

    def close(self, timeout_s: float = 10.0) -> None:
        """SIGTERM every owned worker and wait for the drains."""
        with self._lock:
            procs = list(self._procs)
            self._procs = []
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5.0)
