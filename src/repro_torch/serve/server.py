"""Partition server: queued serving over single-device workers — the JAX
package's ``serve/server.py`` on torch, for ``devices_per_mesh == 1``.

``PartitionServer`` is the traffic-shaped layer above the facade
(saxml-style: an admission queue feeding several independent workers).
It owns N *workers*, each a single-thread ``PartitionSession`` on the
server's torch device (with several workers on one card, they share it
and its current stream); a priority admission queue with per-request
deadlines; a dispatcher that routes each request to the best-fitting
worker (``serve.scheduler``, reusing the ``auto`` policy's
``required_devices``); a ``GraphSpec`` cache shared across all workers;
and supervision — a failed or timed-out attempt is retried once on
another worker, then surfaced as a structured :class:`ServeResult`
error. Multi-device meshes (``devices_per_mesh > 1``) wait for the
distributed engine (ROADMAP.md, queue 1 item 5) and raise.

Results are bit-identical to solo ``Partitioner.run`` for the same
request: workers run the unmodified facade, and every request is a pure
function of its fields regardless of which worker executes it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from queue import SimpleQueue
from typing import Any, Dict, Iterable, List, Optional

from ..api.backends import required_devices
from ..api.session import BucketCache, PartitionSession
from ..kernels.dispatch import resolve_device
from .metrics import ServeMetrics
from .queue import AdmissionQueue, Ticket
from .scheduler import pick_worker

_STOP = object()  # worker-inbox sentinel

# structured error codes a ServeResult can carry
ERR_DEADLINE = "deadline_exceeded"
ERR_WORKER = "worker_failed"
ERR_NO_WORKER = "no_worker"
ERR_REJECTED = "rejected"
ERR_CLOSED = "server_closed"


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Outcome of one served request: a ``PartitionResult`` on success,
    a structured error otherwise — queue failures are *data*, never
    exceptions leaking out of worker threads.
    """

    ok: bool
    result: Optional[object]  # PartitionResult when ok
    error: Optional[str]  # ERR_* code when not ok
    detail: str = ""
    worker: Optional[int] = None  # worker that produced the result
    attempts: int = 0  # run attempts consumed
    priority: int = 0
    queue_wait_s: float = 0.0  # admission -> first dispatch
    total_s: float = 0.0  # admission -> resolution

    def summary(self) -> Dict[str, Any]:
        """JSON-serializable one-liner (no assignment array)."""
        out: Dict[str, Any] = {
            "ok": self.ok,
            "worker": self.worker,
            "attempts": self.attempts,
            "priority": self.priority,
            "queue_wait_s": self.queue_wait_s,
            "total_s": self.total_s,
        }
        if self.ok and self.result is not None:
            out["cut"] = self.result.cut
            out["feasible"] = self.result.feasible
            out["backend"] = self.result.backend
        else:
            out["error"] = self.error
            out["detail"] = self.detail
        return out


class _Worker:
    """One worker: a dedicated single-thread ``PartitionSession`` (the
    executor) on the server's device plus a supervisor loop (this
    thread) that enforces per-attempt timeouts and reports failures back
    to the server.

    ``hold()`` / ``release()`` gate the loop before each attempt — the
    supervision hook the tests use to kill a worker while it provably
    still owns a request.
    """

    def __init__(
        self,
        wid: int,
        devices: int,
        backend: Optional[str],
        server: "PartitionServer",
    ):
        self.wid = wid
        self.devices = devices
        self.alive = True
        self.inflight = 0  # guarded by server._cap_cond
        self.session = PartitionSession(
            devices=devices,
            backend=backend,
            max_workers=1,
            graph_cache=server._graph_cache,
            graph_cache_lock=server._graph_cache_lock,
            stack=server._stack,
            device=server.device,
        )
        self.inbox: SimpleQueue = SimpleQueue()
        self._gate = threading.Event()
        self._gate.set()
        self._abandoned: Optional[Future] = None
        self._server = server
        self.thread = threading.Thread(
            target=self._loop,
            name=f"repro-torch-serve-w{wid}",
            daemon=True,
        )

    def start(self) -> None:
        self.thread.start()

    def hold(self) -> None:
        self._gate.clear()

    def release(self) -> None:
        self._gate.set()

    def _loop(self) -> None:
        while True:
            item = self.inbox.get()  # a List[Ticket] batch, or _STOP
            if item is _STOP:
                break
            try:
                if len(item) == 1:
                    self._serve_solo(item[0])
                else:
                    self._serve_batch(item)
            finally:
                self._server._attempt_finished(self)

    def _serve_solo(self, ticket: Ticket) -> None:
        srv = self._server
        self._gate.wait()
        if srv._closing.is_set():
            srv._resolve_error(
                ticket, ERR_CLOSED, "server closed before the attempt"
            )
            return
        if not self.alive:
            srv._attempt_failed(
                ticket, self.wid, "worker killed before the attempt"
            )
            return
        now = time.monotonic()
        if ticket.expired(now):
            srv._resolve_error(
                ticket,
                ERR_DEADLINE,
                f"deadline passed before the attempt on worker {self.wid}",
            )
            return
        timeout = ticket.timeout_s
        rem = ticket.remaining(now)
        deadline_bound = False
        if rem is not None and (timeout is None or rem < timeout):
            # the request's own deadline is the binding constraint: if
            # it fires, the *request* ran out of time — the worker is
            # slow for this job, not wedged, and must stay in rotation
            timeout = rem
            deadline_bound = True
        if not self._drain_abandoned([ticket], timeout):
            return
        fut = self.session.submit(ticket.request)
        try:
            res = fut.result(timeout=timeout)
        except _FutureTimeout:
            if deadline_bound:
                self._abandoned = fut
                srv._resolve_error(
                    ticket,
                    ERR_DEADLINE,
                    f"deadline passed mid-attempt on worker {self.wid}",
                )
                return
            # a timeout_s overrun means the session's executor thread
            # is wedged; take this worker out of rotation and fail over
            self.alive = False
            srv._attempt_failed(
                ticket,
                self.wid,
                f"attempt timed out after {timeout:.3f}s"
                " (worker marked dead)",
            )
            return
        except Exception as exc:  # any failure must become data
            srv._attempt_failed(
                ticket, self.wid, f"{type(exc).__name__}: {exc}"
            )
            return
        srv._resolve_ok(ticket, res, self.wid)

    def _serve_batch(self, tickets: List[Ticket]) -> None:
        """One batched attempt: every ticket shares one submit_many
        future (coalescing + optional stacked level-0 happen inside the
        session), each resolving to its own bit-identical result."""
        srv = self._server
        self._gate.wait()
        if srv._closing.is_set():
            for t in tickets:
                srv._resolve_error(
                    t, ERR_CLOSED, "server closed before the attempt"
                )
            return
        if not self.alive:
            for t in tickets:
                srv._attempt_failed(
                    t, self.wid, "worker killed before the attempt"
                )
            return
        now = time.monotonic()
        live = []
        for t in tickets:
            if t.expired(now):
                srv._resolve_error(
                    t,
                    ERR_DEADLINE,
                    f"deadline passed before the attempt on worker "
                    f"{self.wid}",
                )
            else:
                live.append(t)
        if not live:
            return
        if len(live) == 1:
            # fall back to the solo path and its exact attempt semantics
            return self._serve_solo(live[0])
        # the batch attempt's bound is the loosest member budget (None
        # when any member is unbounded). A timeout only counts as a
        # wedged-worker signal when some member's own timeout_s was the
        # binding constraint; all-deadline-bound overruns abandon the
        # attempt and keep the worker in rotation, as in the solo path.
        bounds: List[float] = []
        unbounded = False
        deadline_bound = True
        for t in live:
            rem = t.remaining(now)
            to = t.timeout_s
            if rem is not None and (to is None or rem < to):
                bounds.append(rem)
            elif to is not None:
                bounds.append(to)
                deadline_bound = False
            else:
                unbounded = True
        timeout = None if unbounded else max(bounds)
        if not self._drain_abandoned(live, timeout):
            return
        fut = self.session.submit_many([t.request for t in live])
        try:
            results = fut.result(timeout=timeout)
        except _FutureTimeout:
            if deadline_bound:
                self._abandoned = fut
                for t in live:
                    srv._resolve_error(
                        t,
                        ERR_DEADLINE,
                        f"deadline passed mid-attempt on worker {self.wid}",
                    )
                return
            self.alive = False
            for t in live:
                srv._attempt_failed(
                    t,
                    self.wid,
                    f"attempt timed out after {timeout:.3f}s"
                    " (worker marked dead)",
                )
            return
        except Exception as exc:  # any failure must become data
            for t in live:
                srv._attempt_failed(
                    t, self.wid, f"{type(exc).__name__}: {exc}"
                )
            return
        from .batching import distinct_count

        srv._metrics.on_batch(
            len(live), distinct_count([t.request for t in live])
        )
        now = time.monotonic()
        for t, res in zip(live, results):
            if t.expired(now):
                # the batch outlived this member's deadline: the solo
                # contract (a result only counts inside the deadline)
                # wins over the computed-anyway result
                srv._resolve_error(
                    t,
                    ERR_DEADLINE,
                    f"deadline passed mid-attempt on worker {self.wid}",
                )
            else:
                srv._resolve_ok(t, res, self.wid)

    def _drain_abandoned(self, tickets: List[Ticket], budget) -> bool:
        """A deadline-abandoned attempt keeps the session's executor
        thread busy after its ticket resolved. Its runtime is *this
        worker's backlog*, not the next attempt's cost — so drain it
        before starting (and timing) a fresh attempt. If the drain
        exceeds the new tickets' budget the mesh simply can't take the
        job in time: fail over WITHOUT marking the worker dead (the
        executor is making progress on real work, not wedged). Returns
        False when the tickets were already resolved/failed over."""
        if self._abandoned is None:
            return True
        try:
            self._abandoned.result(timeout=budget)
        except _FutureTimeout:
            for t in tickets:
                self._server._attempt_failed(
                    t,
                    self.wid,
                    "worker busy draining a deadline-abandoned attempt",
                )
            return False
        except Exception:
            pass  # the abandoned job failed; the executor is free
        self._abandoned = None
        return True


class PartitionServer:
    """Queued serving tier over the ``repro_torch.api`` facade.

    Parameters
    ----------
    meshes:
        Number of workers, each a single-device session on ``device``
        (several workers share one card).
    devices_per_mesh:
        PE count of every worker; only 1 is ported (more raises
        ``NotImplementedError``: multi-device meshes wait for the
        distributed engine, ROADMAP.md queue 1 item 5).
    backend:
        Optional registry name replacing each request's ``"auto"``.
    max_queue:
        Admission-queue capacity; submissions beyond it resolve to a
        structured ``rejected`` error instead of blocking the caller.
    max_retries:
        Failed/timed-out attempts per request before the error is
        surfaced (default 1: one retry on a *different* mesh).
    max_inflight_per_worker:
        Attempts a worker may own at once (assigned + running). The
        default of 1 keeps requests in the priority queue — where
        scheduling decisions are still possible — rather than in
        per-worker inboxes. A batch counts as one attempt.
    batch_max:
        Most tickets one dispatch may serve as a single batched attempt
        (same shape bucket, see ``serve.batching``); 1 disables
        batching entirely.
    batch_window_ms:
        How long the dispatcher lingers for same-bucket stragglers once
        a batch leader popped and fewer than ``batch_max`` companions
        are queued. Small on purpose: the window trades that much p50
        latency for batch fill under bursty admission.
    graph_cache_size:
        LRU bound of the server-shared ``GraphSpec -> Graph`` cache
        (bounded so diverse long-lived traffic cannot leak memory).
    stack:
        Stacked level-0 execution knob threaded to every worker session
        (``"auto"`` | ``"on"`` | ``"off"``, see ``serve.batching``).
    device:
        The torch device every worker runs on: the card by default
        (raising without one), ``"cpu"`` on purpose.
    """

    def __init__(
        self,
        meshes: int = 2,
        devices_per_mesh: int = 1,
        backend: Optional[str] = None,
        max_queue: int = 1024,
        max_retries: int = 1,
        max_inflight_per_worker: int = 1,
        batch_max: int = 8,
        batch_window_ms: float = 2.0,
        graph_cache_size: int = 64,
        stack: str = "auto",
        device=None,
    ):
        if meshes < 1:
            raise ValueError(f"meshes must be >= 1, got {meshes}")
        if devices_per_mesh < 1:
            raise ValueError(
                f"devices_per_mesh must be >= 1, got {devices_per_mesh}"
            )
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if max_inflight_per_worker < 1:
            raise ValueError(
                "max_inflight_per_worker must be >= 1, got "
                f"{max_inflight_per_worker}"
            )
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        if batch_window_ms < 0:
            raise ValueError(
                f"batch_window_ms must be >= 0, got {batch_window_ms}"
            )
        if devices_per_mesh > 1:
            raise NotImplementedError(
                f"PartitionServer(devices_per_mesh={devices_per_mesh}): "
                "multi-device meshes need the distributed engine, which "
                "is not ported to repro_torch yet (ROADMAP.md, queue 1 "
                "item 5)")
        self.devices_per_mesh = devices_per_mesh
        self.device = resolve_device(device)
        self._backend = backend
        self._max_retries = max_retries
        self._max_inflight = max_inflight_per_worker
        self._batch_max = batch_max
        self._batch_window_s = batch_window_ms / 1000.0
        self._stack = stack
        self._graph_cache = BucketCache(graph_cache_size)
        self._graph_cache_lock = threading.Lock()
        self._workers = [
            _Worker(i, devices_per_mesh, backend, self)
            for i in range(meshes)
        ]
        self._queue = AdmissionQueue(capacity=max_queue)
        self._metrics = ServeMetrics(meshes)
        self._cap_cond = threading.Condition()
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._closing = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name="repro-torch-serve-dispatch",
            daemon=True,
        )
        for w in self._workers:
            w.start()
        self._dispatcher.start()

    # -- admission -----------------------------------------------------

    def submit(
        self,
        request: Any,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> "Future[ServeResult]":
        """Admit one request; returns a future resolving to a
        :class:`ServeResult` (admission overload resolves it
        immediately with a ``rejected`` error). Lower ``priority``
        dispatches first; ``deadline_s``/``timeout_s`` are relative
        seconds from now (see :class:`Ticket`)."""
        if self._closing.is_set():
            raise RuntimeError("server is closed")
        request.validate()
        # quality routing: a deadline-bearing ticket
        # that asked for quality="best" is downgraded to the fast tier
        # at admission — the unconstrained refinement spends extra
        # wall time on cut quality that a deadline-tight caller cannot
        # use. Deterministic (pure function of the submit arguments),
        # and an explicit refine= override is always honored.
        if deadline_s is not None and getattr(request, "quality", None) \
                == "best" and getattr(request, "refine", None) is None:
            request = dataclasses.replace(request, quality="fast")
            self._metrics.on_downgrade()
        # route on the backend that will actually run: the server-level
        # override replaces "auto" exactly as the worker sessions do.
        # Graph and GraphSpec both expose n — no materialization here.
        eff = request
        if self._backend is not None and request.backend == "auto":
            eff = dataclasses.replace(request, backend=self._backend)
        need = required_devices(eff, request.graph.n)
        bucket = None
        if self._batch_max > 1 and need == 1:
            from .batching import bucket_of

            bucket = bucket_of(eff)
        now = time.monotonic()
        fut: "Future[ServeResult]" = Future()
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        ticket = Ticket(
            request=request,
            priority=priority,
            seq=seq,
            future=fut,
            submit_t=now,
            deadline=None if deadline_s is None else now + deadline_s,
            timeout_s=timeout_s,
            need=need,
            bucket=bucket,
        )
        if not self._queue.put(ticket):
            if self._closing.is_set():
                # lost the race against close(): the queue refused the
                # ticket because it is closed, not because it is full
                fut.set_result(
                    ServeResult(
                        ok=False,
                        result=None,
                        error=ERR_CLOSED,
                        detail="server closed during submit",
                        priority=priority,
                    )
                )
                return fut
            self._metrics.on_reject()
            cap = self._queue.capacity
            fut.set_result(
                ServeResult(
                    ok=False,
                    result=None,
                    error=ERR_REJECTED,
                    detail=f"admission queue full (capacity {cap})",
                    priority=priority,
                )
            )
            return fut
        self._metrics.on_submit(self._queue.depth())
        with self._cap_cond:
            self._cap_cond.notify_all()
        return fut

    def serve(self, requests: Iterable, **submit_kw) -> List[ServeResult]:
        """Admit a batch and block for all results, in request order."""
        futures = [self.submit(r, **submit_kw) for r in requests]
        return [f.result() for f in futures]

    # -- dispatch ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        # the dispatcher never blocks on a single ticket: each pass
        # pops the best ticket that *some free eligible mesh* can take
        # right now (pop_matching), so a retried ticket whose only
        # remaining mesh is busy cannot head-of-line block work that
        # an idle mesh could serve
        while not self._closing.is_set():
            if not self._dispatch_once():
                with self._cap_cond:
                    self._cap_cond.wait(0.05)

    def _dispatch_once(self) -> bool:
        """One dispatch action; False when there is nothing to do."""
        # deadlines first: an expired ticket resolves without a mesh
        ticket = self._queue.pop_matching(Ticket.expired)
        if ticket is not None:
            self._metrics.on_dispatch(self._queue.depth())
            self._resolve_error(ticket, ERR_DEADLINE, "expired in queue")
            return True
        with self._cap_cond:
            alive = {w.wid for w in self._workers if w.alive}
            free = {
                w.wid
                for w in self._workers
                if w.alive and w.inflight < self._max_inflight
            }
        # tickets whose every eligible mesh is dead can never be served
        ticket = self._queue.pop_matching(lambda t: not (alive - t.excluded))
        if ticket is not None:
            detail = "; ".join(ticket.errors) or "no live worker"
            self._resolve_error(ticket, ERR_NO_WORKER, detail)
            return True
        if not free:
            return False
        ticket = self._queue.pop_matching(lambda t: bool(free - t.excluded))
        if ticket is None:
            return False
        self._metrics.on_dispatch(self._queue.depth())
        if ticket.dispatch_t is None:
            ticket.dispatch_t = time.monotonic()
        batch = [ticket]
        if ticket.bucket is not None and self._batch_max > 1:
            batch += self._collect_batch(ticket)
        self._assign_now(batch)
        return True

    def _collect_batch(self, leader: Ticket) -> List[Ticket]:
        """Same-bucket companions for a popped batch leader, lingering
        ``batch_window_ms`` for stragglers. Companions must be
        first-attempt tickets (a retry carries an exclusion set and its
        own attempt accounting — it keeps the solo path)."""
        companions = self._queue.pop_batch(
            lambda t: t.bucket == leader.bucket and not t.excluded,
            limit=self._batch_max - 1,
            window_s=self._batch_window_s,
        )
        if companions:
            now = time.monotonic()
            for t in companions:
                if t.dispatch_t is None:
                    t.dispatch_t = now
            self._metrics.on_dispatch(self._queue.depth())
        return companions

    def _assign_now(self, batch: List[Ticket]) -> None:
        """Hand the batch to the best free eligible worker; if the
        free set changed under us (a concurrent kill), requeue — the
        next pass re-routes it. Eligibility is the leader's: companions
        are first-attempt tickets with no exclusions."""
        ticket = batch[0]
        with self._cap_cond:
            cands = [
                w
                for w in self._workers
                if w.alive and w.inflight < self._max_inflight
            ]
            cands = [w for w in cands if w.wid not in ticket.excluded]
            chosen = pick_worker(ticket.need, cands)
            if chosen is not None:
                chosen.inflight += 1
        if chosen is None:
            for t in batch:
                if not self._queue.requeue(t):
                    self._resolve_error(
                        t, ERR_CLOSED, "server closed during dispatch"
                    )
            return
        for t in batch:
            t.worker = chosen.wid
        chosen.inbox.put(batch)

    # -- worker callbacks ----------------------------------------------

    def _attempt_finished(self, worker: _Worker) -> None:
        with self._cap_cond:
            worker.inflight -= 1
            self._cap_cond.notify_all()

    def _attempt_failed(self, ticket: Ticket, wid: int, detail: str) -> None:
        """Supervision: record the failure, retry on another mesh when
        the budget and the fleet allow it, else surface the error."""
        ticket.errors.append(f"worker {wid}: {detail}")
        ticket.excluded.add(wid)
        ticket.attempts += 1
        can_retry = (
            ticket.attempts <= self._max_retries
            and not self._closing.is_set()
        )
        if can_retry:
            with self._cap_cond:
                elsewhere = any(
                    w.alive and w.wid not in ticket.excluded
                    for w in self._workers
                )
            can_retry = elsewhere
        if can_retry and self._queue.requeue(ticket):
            self._metrics.on_retry()
            return
        self._resolve_error(ticket, ERR_WORKER, "; ".join(ticket.errors))

    # -- resolution ----------------------------------------------------

    def _resolve_ok(self, ticket: Ticket, result, wid: int) -> None:
        now = time.monotonic()
        qw = (ticket.dispatch_t or now) - ticket.submit_t
        total = now - ticket.submit_t
        self._metrics.on_done(True, total, qw, wid)
        self._set(
            ticket.future,
            ServeResult(
                ok=True,
                result=result,
                error=None,
                worker=wid,
                attempts=ticket.attempts + 1,
                priority=ticket.priority,
                queue_wait_s=round(qw, 6),
                total_s=round(total, 6),
            ),
        )

    def _resolve_error(self, ticket: Ticket, code: str, detail: str) -> None:
        now = time.monotonic()
        qw = (ticket.dispatch_t or now) - ticket.submit_t
        total = now - ticket.submit_t
        self._metrics.on_done(
            False, total, qw, None, expired=code == ERR_DEADLINE
        )
        self._set(
            ticket.future,
            ServeResult(
                ok=False,
                result=None,
                error=code,
                detail=detail,
                worker=None,
                attempts=ticket.attempts,
                priority=ticket.priority,
                queue_wait_s=round(qw, 6),
                total_s=round(total, 6),
            ),
        )

    @staticmethod
    def _set(fut: Future, res: ServeResult) -> None:
        try:
            fut.set_result(res)
        except Exception:  # cancelled by the caller — drop the result
            pass

    # -- introspection / supervision -----------------------------------

    def metrics_window(self) -> Dict[str, Any]:
        """Windowed metrics deltas since the last call (see
        ``ServeMetrics.snapshot_window``) plus the live queue depth —
        the rate signal a fabric worker heartbeats to the front door
        and the autoscaler consumes."""
        win = self._metrics.snapshot_window()
        win["queue_depth_last"] = self._queue.depth()
        win["inflight"] = sum(w.inflight for w in self._workers)
        win["alive_workers"] = sum(1 for w in self._workers if w.alive)
        return win

    def stats(self) -> Dict[str, Any]:
        snap = self._metrics.snapshot()
        served = snap["per_worker_served"]
        snap.update(
            {
                "meshes": len(self._workers),
                "devices_per_mesh": self.devices_per_mesh,
                "queue_depth": self._queue.depth(),
                "workers": [
                    {
                        "wid": w.wid,
                        "devices": w.devices,
                        "alive": w.alive,
                        "inflight": w.inflight,
                        "served": served[w.wid],
                    }
                    for w in self._workers
                ],
            }
        )
        return snap

    @property
    def workers(self) -> List[_Worker]:
        return list(self._workers)

    def kill_worker(self, wid: int) -> None:
        """Take worker ``wid`` out of rotation. Attempts it still owns
        (and any it would have started) fail over to other meshes via
        the normal retry path — takes effect before the worker's next
        attempt starts; it cannot interrupt a running attempt."""
        w = self._workers[wid]
        with self._cap_cond:
            w.alive = False
            self._cap_cond.notify_all()
        w.release()  # free a held worker so its ticket can fail over

    # -- lifecycle -----------------------------------------------------

    def close(self, wait: bool = True) -> None:
        """Stop admission, resolve every queued ticket with a
        ``server_closed`` error, and shut workers down. Attempts already
        running complete normally when ``wait`` is True (wedged/timed-out
        workers are never waited on)."""
        if self._closing.is_set():
            return
        self._closing.set()
        self._queue.close()
        for t in self._queue.drain():
            self._resolve_error(t, ERR_CLOSED, "server closed before dispatch")
        with self._cap_cond:
            self._cap_cond.notify_all()
        self._dispatcher.join(timeout=5.0)
        for w in self._workers:
            w.inbox.put(_STOP)
            w.release()
        if wait:
            for w in self._workers:
                if w.alive:
                    w.thread.join(timeout=30.0)
        for w in self._workers:
            w.session.close(wait=wait and w.alive)

    def __enter__(self) -> "PartitionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
