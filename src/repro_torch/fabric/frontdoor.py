"""RPC front door: admission, routing and failover across worker
*processes* — port of ``repro.fabric.frontdoor``.

``FrontDoor`` is the cross-process analogue of ``PartitionServer``: a
TCP listener admitting ``partition`` frames into the same
``AdmissionQueue``/``Ticket`` machinery, a dispatcher routing each
ticket to the best-fitting *registered server* (``scheduler.pick_server``
— the in-process mesh policy lifted to server granularity), and the
in-process tier's failover contract at process scope: a lost work
connection or an expired lease orphans that server's in-flight tickets
back into the queue with the server excluded, so they retry elsewhere or
surface a structured error — an admitted ticket always resolves, even
when the process that owned it was SIGKILLed.

Workers announce themselves over heartbeat connections
(``register``/``renew``, see ``fabric.registry``); the front door dials
each registered server's work port and multiplexes ``partition`` frames
over that one connection, matching ``result`` frames back to tickets by
id. An optional :class:`fabric.autoscaler.AutoscalePolicy` watches the
front door's windowed metrics and grows/shrinks a ``ProcessScaler``
fleet of local worker processes.

The front door never touches a CUDA device (it owns no devices):
routing uses the same pure ``required_devices`` policy as the
in-process scheduler, and assignments cross it as opaque encoded
payloads — only worker processes ever run a partition.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Set

from ..api.backends import required_devices
from ..serve.metrics import ServeMetrics
from ..serve.queue import AdmissionQueue, Ticket
from ..serve.scheduler import pick_server
from ..serve.server import (
    ERR_CLOSED,
    ERR_DEADLINE,
    ERR_NO_WORKER,
    ERR_REJECTED,
    ERR_WORKER,
)
from . import protocol
from .autoscaler import AutoscaleConfig, AutoscalePolicy, ProcessScaler
from .protocol import recv_msg, send_msg
from .registry import ServerRegistry

# worker-reported structured errors that justify excluding the server
# and retrying elsewhere (vs. deadline_exceeded, which is the request's
# own fault and passes through)
_RETRYABLE = {ERR_WORKER, ERR_NO_WORKER, ERR_CLOSED, ERR_REJECTED}


class _ServerHandle:
    """One registered server's work connection plus its routing state
    (``inflight``/``pending`` guarded by the front door's condition)."""

    def __init__(self, record, sock: socket.socket):
        self.sid: str = record.server_id
        self.generation: int = record.generation
        self.devices: int = record.devices
        self.capacity: int = max(1, record.meshes)
        self.sock = sock
        self.send_lock = threading.Lock()
        self.inflight = 0
        self.pending: Dict[int, Ticket] = {}
        self.alive = True


class FrontDoor:
    """Cross-process serving front door.

    Parameters
    ----------
    host, port:
        Bind address (``port=0`` picks an ephemeral port; read it back
        from ``self.port``).
    lease_ttl_s:
        Server-lease TTL; a server missing renewals for this long is
        expired and its in-flight work fails over (see
        ``fabric.registry``).
    max_queue:
        Admission bound; beyond it submissions resolve ``rejected``.
    max_retries:
        Failed attempts per ticket before the error surfaces (default
        1: one retry on a *different* server — the in-process tier's
        contract).
    autoscale:
        Optional :class:`AutoscaleConfig`; when set, the front door
        owns a fleet of local worker subprocesses sized by queue
        pressure (see ``fabric.autoscaler``).
    worker_args:
        Extra ``repro_torch.launch.fabric worker`` CLI args for
        autoscaled workers (e.g. ``["--meshes", "2"]``); the front-door
        address is appended automatically.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        lease_ttl_s: float = 5.0,
        max_queue: int = 1024,
        max_retries: int = 1,
        autoscale: Optional[AutoscaleConfig] = None,
        worker_args: Optional[Sequence[str]] = None,
    ):
        self.registry = ServerRegistry(ttl_s=lease_ttl_s)
        self._queue = AdmissionQueue(capacity=max_queue)
        self._metrics = ServeMetrics(0)
        self._max_retries = max_retries
        self._handles: Dict[str, _ServerHandle] = {}
        self._sid_index: Dict[str, int] = {}  # sid -> metrics slot
        self._cond = threading.Condition()
        self._closing = threading.Event()
        self._seq = 0
        self._conns: Set[socket.socket] = set()
        self._conns_lock = threading.Lock()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()[:2]

        self._scaler: Optional[ProcessScaler] = None
        self._policy: Optional[AutoscalePolicy] = None
        if autoscale is not None:
            args = list(worker_args or [])
            args += ["--frontdoor", f"{self.host}:{self.port}"]
            self._policy = AutoscalePolicy(autoscale)
            self._scaler = ProcessScaler(worker_args=args)

        self._threads = [
            threading.Thread(
                target=self._accept_loop,
                name="repro-torch-fabric-fd-accept",
                daemon=True,
            ),
            threading.Thread(
                target=self._dispatch_loop,
                name="repro-torch-fabric-fd-dispatch",
                daemon=True,
            ),
            threading.Thread(
                target=self._expiry_loop,
                name="repro-torch-fabric-fd-expiry",
                daemon=True,
            ),
        ]
        if self._policy is not None:
            scaler_thread = threading.Thread(
                target=self._autoscale_loop,
                name="repro-torch-fabric-fd-autoscale",
                daemon=True,
            )
            self._threads.append(scaler_thread)
        for t in self._threads:
            t.start()

    # -- connections ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._conn_loop,
                args=(conn,),
                daemon=True,
            )
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        """One inbound connection: clients (partition/status) and worker
        heartbeats (register/renew/deregister) share the listener; the
        op stream tells them apart."""
        send_lock = threading.Lock()
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                self._handle(conn, send_lock, msg)
        except (OSError, protocol.ProtocolError, json.JSONDecodeError):
            return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, conn, send_lock, msg: Dict[str, Any]) -> None:
        op = msg.get("op")
        if op == "partition":
            self._admit(conn, send_lock, msg)
        elif op == "register":
            self._on_register(conn, send_lock, msg)
        elif op == "renew":
            sid = msg.get("server_id", "")
            if self.registry.renew(sid, metrics=msg.get("metrics")):
                resp = {
                    "op": "lease",
                    "server_id": sid,
                    "ttl_s": self.registry.ttl_s,
                }
            else:
                resp = {"op": "unknown_server", "server_id": sid}
            self._safe_send(conn, send_lock, resp)
        elif op == "deregister":
            sid = msg.get("server_id", "")
            self.registry.deregister(sid)
            with self._cond:
                handle = self._handles.get(sid)
            if handle is not None:
                # a graceful deregister already answered its pending
                # frames (the worker drains before saying goodbye);
                # anything still pending rides the failover path
                self._on_server_lost(handle, "server deregistered")
            self._safe_send(conn, send_lock, {"op": "bye", "server_id": sid})
        elif op == "status":
            self._safe_send(conn, send_lock, self.status())
        else:
            resp = {"op": "error", "detail": f"unknown op {op!r}"}
            self._safe_send(conn, send_lock, resp)

    @staticmethod
    def _safe_send(conn, send_lock, obj: Dict[str, Any]) -> None:
        try:
            with send_lock:
                send_msg(conn, obj)
        except OSError:
            pass

    # -- worker registration -------------------------------------------

    def _on_register(self, conn, send_lock, msg: Dict[str, Any]) -> None:
        info = msg.get("server") or {}
        try:
            record = self.registry.register(
                server_id=str(info["server_id"]),
                host=str(info["host"]),
                port=int(info["port"]),
                devices=int(info.get("devices", 1)),
                meshes=int(info.get("meshes", 1)),
                pid=info.get("pid"),
            )
        except (KeyError, TypeError, ValueError) as exc:
            resp = {"op": "error", "detail": f"bad register: {exc}"}
            self._safe_send(conn, send_lock, resp)
            return
        resp = {
            "op": "lease",
            "server_id": record.server_id,
            "ttl_s": self.registry.ttl_s,
        }
        self._safe_send(conn, send_lock, resp)
        # dial the work connection outside the registry lock; a
        # re-registration (restarted worker, new generation) replaces
        # any stale handle, failing its orphans over
        t = threading.Thread(
            target=self._ensure_handle,
            args=(record,),
            daemon=True,
        )
        t.start()

    def _ensure_handle(self, record) -> None:
        with self._cond:
            old = self._handles.get(record.server_id)
        if old is not None:
            if old.generation == record.generation and old.alive:
                return  # already connected to this incarnation
            self._on_server_lost(old, "replaced by re-registration")
        try:
            sock = protocol.connect(record.host, record.port, timeout=5.0)
            # the timeout bounds the dial only: a result may take longer
            # than any fixed bound (the reference keeps it, and so loses
            # every worker whose run outlasts 5 s)
            sock.settimeout(None)
        except OSError as exc:
            # unreachable worker: drop the lease so it re-registers
            # (and re-announces a reachable address) on its next beat
            self.registry.deregister(record.server_id)
            self._log_unreachable(record, exc)
            return
        handle = _ServerHandle(record, sock)
        with self._cond:
            if self._closing.is_set():
                handle.alive = False
            else:
                self._handles[record.server_id] = handle
                self._sid_index.setdefault(
                    record.server_id, len(self._sid_index)
                )
            self._cond.notify_all()
        if not handle.alive:
            sock.close()
            return
        t = threading.Thread(
            target=self._recv_loop,
            args=(handle,),
            daemon=True,
        )
        t.start()

    @staticmethod
    def _log_unreachable(record, exc) -> None:
        import logging

        logging.getLogger(__name__).warning(
            "fabric: server %s advertised %s:%d but is unreachable (%s)",
            record.server_id,
            record.host,
            record.port,
            exc,
        )

    def _recv_loop(self, handle: _ServerHandle) -> None:
        """Match ``result`` frames back to pending tickets; any
        connection failure fails the handle over."""
        try:
            while True:
                msg = recv_msg(handle.sock)
                if msg is None:
                    break
                if msg.get("op") == "result":
                    self._on_result(handle, msg)
        except (OSError, protocol.ProtocolError, json.JSONDecodeError):
            pass
        self._on_server_lost(handle, "work connection lost")

    # -- admission -----------------------------------------------------

    def submit(
        self,
        request,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> "Future[dict]":
        """Local (in-process) admission — the transport-free core the
        RPC ``partition`` op rides on. Resolves to a *wire dict* (see
        ``protocol.decode_result`` for the typed client view)."""
        if self._closing.is_set():
            raise RuntimeError("front door is closed")
        request.validate()
        need = required_devices(request, request.graph.n)
        now = time.monotonic()
        fut: "Future[dict]" = Future()
        with self._cond:
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
        )
        if not self._queue.put(ticket):
            code = ERR_CLOSED if self._closing.is_set() else ERR_REJECTED
            if code == ERR_REJECTED:
                self._metrics.on_reject()
                cap = self._queue.capacity
                detail = f"admission queue full (capacity {cap})"
            else:
                detail = "front door closed during submit"
            fut.set_result(protocol.error_result(code, detail))
            return fut
        self._metrics.on_submit(self._queue.depth())
        with self._cond:
            self._cond.notify_all()
        return fut

    def _admit(self, conn, send_lock, msg: Dict[str, Any]) -> None:
        rid = msg.get("id")

        def reply(wire: Dict[str, Any]) -> None:
            frame = {"op": "result", "id": rid, "result": wire}
            self._safe_send(conn, send_lock, frame)

        try:
            req = protocol.decode_request(msg["request"])
            fut = self.submit(
                req,
                priority=int(msg.get("priority", 0)),
                deadline_s=msg.get("deadline_s"),
                timeout_s=msg.get("timeout_s"),
            )
        except protocol.ProtocolError as exc:  # bad frame is data
            reply(protocol.error_result(ERR_REJECTED, str(exc)))
            return
        except RuntimeError as exc:
            reply(protocol.error_result(ERR_CLOSED, str(exc)))
            return
        except Exception as exc:  # malformed request is data
            detail = f"{type(exc).__name__}: {exc}"
            reply(protocol.error_result(ERR_REJECTED, detail))
            return
        fut.add_done_callback(lambda f: reply(f.result()))

    # -- dispatch ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._closing.is_set():
            if not self._dispatch_once():
                with self._cond:
                    self._cond.wait(0.05)

    def _dispatch_once(self) -> bool:
        """One dispatch action; False when there is nothing to do.
        Mirrors ``PartitionServer._dispatch_once`` at server
        granularity, with one deliberate difference: a *fresh* ticket
        with zero live servers waits in the queue (its deadline still
        enforced) instead of resolving ``no_worker`` — workers register
        asynchronously, and the autoscaler may be about to spawn one.
        Only a ticket that already failed somewhere and has no
        non-excluded live server left resolves ``no_worker``."""
        ticket = self._queue.pop_matching(Ticket.expired)
        if ticket is not None:
            self._metrics.on_dispatch(self._queue.depth())
            wire = protocol.error_result(
                ERR_DEADLINE,
                "expired in front-door queue",
                attempts=ticket.attempts,
            )
            self._resolve_wire(ticket, wire)
            return True
        with self._cond:
            handles = [h for h in self._handles.values() if h.alive]
            alive = {h.sid for h in handles}
            free = {h.sid for h in handles if h.inflight < h.capacity}
        ticket = self._queue.pop_matching(
            lambda t: bool(t.excluded) and not (alive - t.excluded)
        )
        if ticket is not None:
            detail = "; ".join(ticket.errors) or "no live server"
            wire = protocol.error_result(
                ERR_NO_WORKER,
                detail,
                attempts=ticket.attempts,
            )
            self._resolve_wire(ticket, wire)
            return True
        if not free:
            return False
        ticket = self._queue.pop_matching(lambda t: bool(free - t.excluded))
        if ticket is None:
            return False
        self._metrics.on_dispatch(self._queue.depth())
        if ticket.dispatch_t is None:
            ticket.dispatch_t = time.monotonic()
        self._assign_now(ticket)
        return True

    def _assign_now(self, ticket: Ticket) -> None:
        with self._cond:
            views = []
            for h in self._handles.values():
                if not h.alive or h.inflight >= h.capacity:
                    continue
                if h.sid in ticket.excluded:
                    continue
                view = SimpleNamespace(
                    sid=h.sid,
                    devices=h.devices,
                    inflight=h.inflight,
                    handle=h,
                )
                views.append(view)
            view = pick_server(ticket.need, views)
            if view is None:
                # the free set changed under us; requeue for re-routing
                if not self._queue.requeue(ticket):
                    wire = protocol.error_result(
                        ERR_CLOSED,
                        "front door closed during dispatch",
                        attempts=ticket.attempts,
                    )
                    self._resolve_wire(ticket, wire)
                return
            chosen: _ServerHandle = view.handle
            chosen.inflight += 1
            chosen.pending[ticket.seq] = ticket
        frame = {
            "op": "partition",
            "id": ticket.seq,
            "request": protocol.encode_request(ticket.request),
            "priority": ticket.priority,
            "deadline_s": ticket.remaining(),
            "timeout_s": ticket.timeout_s,
        }
        try:
            with chosen.send_lock:
                send_msg(chosen.sock, frame)
        except OSError:
            self._on_server_lost(chosen, "send failed")

    # -- results / failover --------------------------------------------

    def _on_result(self, handle: _ServerHandle, msg: Dict[str, Any]) -> None:
        with self._cond:
            ticket = handle.pending.pop(msg.get("id"), None)
            if ticket is not None:
                handle.inflight -= 1
            self._cond.notify_all()
        if ticket is None:
            return  # late result for a ticket that already failed over
        wire = msg.get("result") or {}
        if wire.get("ok") or wire.get("error") == ERR_DEADLINE:
            self._resolve_wire(ticket, wire)
        elif wire.get("error") in _RETRYABLE:
            detail = f"{wire.get('error')}: {wire.get('detail', '')}"
            self._attempt_failed(ticket, handle.sid, detail)
        else:  # unknown error code: surface it as-is, annotated
            self._resolve_wire(ticket, wire)

    def _on_server_lost(self, handle: _ServerHandle, reason: str) -> None:
        """A dead work connection (or expired lease): orphaned tickets
        fail over exactly like a killed in-process mesh worker."""
        with self._cond:
            if not handle.alive:
                return
            handle.alive = False
            orphans = list(handle.pending.values())
            handle.pending.clear()
            handle.inflight = 0
            cur = self._handles.get(handle.sid)
            if cur is handle:
                del self._handles[handle.sid]
            self._cond.notify_all()
        try:
            handle.sock.close()
        except OSError:
            pass
        self.registry.deregister(handle.sid)
        for t in orphans:
            self._attempt_failed(t, handle.sid, reason)

    def _attempt_failed(self, ticket: Ticket, sid: str, detail: str) -> None:
        """The in-process tier's supervision at server scope: record,
        exclude, retry while the budget allows — the queue's no-server
        rule surfaces ``no_worker`` if nowhere is left to go."""
        ticket.errors.append(f"server {sid}: {detail}")
        ticket.excluded.add(sid)
        ticket.attempts += 1
        can_retry = (
            ticket.attempts <= self._max_retries
            and not self._closing.is_set()
        )
        if can_retry and self._queue.requeue(ticket):
            self._metrics.on_retry()
            with self._cond:
                self._cond.notify_all()
            return
        wire = protocol.error_result(
            ERR_WORKER,
            "; ".join(ticket.errors),
            attempts=ticket.attempts,
        )
        self._resolve_wire(ticket, wire)

    def _resolve_wire(self, ticket: Ticket, wire: Dict[str, Any]) -> None:
        """Annotate with front-door timings/attempts and resolve."""
        now = time.monotonic()
        qw = (ticket.dispatch_t or now) - ticket.submit_t
        total = now - ticket.submit_t
        wire = dict(wire)
        wire["attempts"] = ticket.attempts + (1 if wire.get("ok") else 0)
        wire["queue_wait_s"] = round(qw, 6)
        wire["total_s"] = round(total, 6)
        sid = wire.get("server")
        widx = self._sid_index.get(sid) if sid is not None else None
        self._metrics.on_done(
            bool(wire.get("ok")),
            total,
            qw,
            widx,
            expired=wire.get("error") == ERR_DEADLINE,
        )
        try:
            ticket.future.set_result(wire)
        except Exception:
            pass  # double resolution (late result raced a failover)

    # -- lease expiry / autoscaling ------------------------------------

    def _expiry_loop(self) -> None:
        period = max(0.05, min(0.5, self.registry.ttl_s / 4.0))
        while not self._closing.wait(period):
            for record in self.registry.expire():
                with self._cond:
                    handle = self._handles.get(record.server_id)
                if handle is not None:
                    self._on_server_lost(
                        handle,
                        f"lease expired after {self.registry.ttl_s:.1f}s "
                        "without a heartbeat",
                    )

    def _autoscale_loop(self) -> None:
        policy, scaler = self._policy, self._scaler
        period = policy.cfg.eval_period_s
        while not self._closing.wait(period):
            win = self._metrics.snapshot_window()
            with self._cond:
                inflight = sum(
                    h.inflight for h in self._handles.values() if h.alive
                )
            workers = max(len(self.registry.alive()), scaler.count())
            act = policy.observe(
                workers=workers,
                queue_depth=self._queue.depth(),
                deadline_misses=win["expired"],
                submitted=win["submitted"],
                inflight=inflight,
            )
            if act > 0 or workers < policy.cfg.min_workers:
                scaler.scale_up()
            elif act < 0:
                scaler.scale_down()

    # -- introspection / lifecycle -------------------------------------

    def status(self) -> Dict[str, Any]:
        per_server: Dict[str, Dict[str, Any]] = {}
        with self._cond:
            for h in self._handles.values():
                per_server[h.sid] = {
                    "inflight": h.inflight,
                    "pending": len(h.pending),
                    "alive": h.alive,
                }
        servers: List[Dict[str, Any]] = []
        for rec in self.registry.alive():
            row = rec.summary()
            row.update(per_server.get(rec.server_id, {}))
            servers.append(row)
        out = {
            "op": "status",
            "host": self.host,
            "port": self.port,
            "servers": servers,
            "queue_depth": self._queue.depth(),
            "metrics": self._metrics.snapshot(),
        }
        if self._scaler is not None:
            out["autoscaler"] = {
                "procs": self._scaler.count(),
                "config": dataclasses.asdict(self._policy.cfg),
            }
        return out

    def close(self) -> None:
        """Stop admission, resolve queued tickets ``server_closed``,
        drop every server connection (their pending tickets resolve
        too) and reap autoscaled workers."""
        if self._closing.is_set():
            return
        self._closing.set()
        self._queue.close()
        for t in self._queue.drain():
            wire = protocol.error_result(
                ERR_CLOSED,
                "front door closed before dispatch",
                attempts=t.attempts,
            )
            self._resolve_wire(t, wire)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._cond:
            handles = list(self._handles.values())
            self._cond.notify_all()
        for h in handles:
            with self._cond:
                orphans = list(h.pending.values())
                h.pending.clear()
                h.alive = False
                self._handles.pop(h.sid, None)
            for t in orphans:
                wire = protocol.error_result(
                    ERR_CLOSED,
                    "front door closed",
                    attempts=t.attempts,
                )
                self._resolve_wire(t, wire)
            try:
                h.sock.close()
            except OSError:
                pass
        if self._scaler is not None:
            self._scaler.close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "FrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
