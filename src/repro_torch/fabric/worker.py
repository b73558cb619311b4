"""Fabric worker: one ``PartitionServer`` process behind an RPC port —
port of ``repro.fabric.worker``.

A worker owns its own device state (its CUDA context, its loaded
kernels, its sessions' graph caches) and exposes the in-process serving
tier over the fabric protocol: ``partition`` ops map to
``PartitionServer.submit`` and stream back encoded ``ServeResult``
frames as they resolve. A heartbeat thread registers the worker with
the front door and renews its lease every few beats, attaching
``PartitionServer.metrics_window()`` — the health/pressure signal the
registry tracks.

Shutdown is graceful (the drain satellite): SIGTERM (or a ``drain``
op) stops admissions — new ``partition`` frames get an immediate
``server_closed`` result — lets in-flight attempts finish, resolves
still-queued tickets as ``server_closed`` (every admitted frame is
answered; a killed process no longer silently drops queued work),
deregisters from the front door, and exits.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import protocol
from .protocol import recv_msg, send_msg


class FabricWorker:
    """RPC shim over one in-process :class:`PartitionServer`.

    Parameters
    ----------
    frontdoor:
        ``(host, port)`` of the front door to register with, or None
        for a standalone worker (tests dial it directly).
    host, port:
        Bind address for the worker's own RPC listener (``port=0``
        picks an ephemeral port; read it back from ``self.port``).
    server:
        An already-built ``PartitionServer`` to serve (tests inject
        one); when None, one is constructed from ``meshes`` /
        ``devices_per_mesh`` / ``backend`` / ``device``.
    device:
        The torch device the constructed server runs on: the card by
        default (raising without one), ``"cpu"`` on purpose.
    process_id:
        This worker's process in a group of workers of one device a mesh
        (``launch/fabric.py worker --num-processes N``): a given
        ``server_id`` S registers as ``S.p<process_id>``, so that the
        group's ids stay distinct.
    group:
        The ``api.group.GroupOwner`` of a worker whose meshes span a
        group of processes (passed on to the constructed server).
    heartbeat_s:
        Lease-renewal cadence. Keep it a small fraction of the front
        door's lease TTL so one dropped beat doesn't expire the lease.
    """

    def __init__(
        self,
        frontdoor: Optional[Tuple[str, int]] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        server_id: Optional[str] = None,
        meshes: int = 1,
        devices_per_mesh: int = 1,
        backend: Optional[str] = None,
        heartbeat_s: float = 1.0,
        server=None,
        max_queue: int = 1024,
        device=None,
        process_id: Optional[int] = None,
        group=None,
    ):
        if server_id is not None and process_id is not None:
            server_id = f"{server_id}.p{process_id}"
        self.server_id = server_id or f"worker-{os.getpid()}"
        self._frontdoor = frontdoor
        self._heartbeat_s = heartbeat_s
        if server is None:
            from ..serve import PartitionServer

            server = PartitionServer(
                meshes=meshes,
                devices_per_mesh=devices_per_mesh,
                backend=backend,
                max_queue=max_queue,
                device=device,
                group=group,
            )
        self._server = server
        self.devices_per_mesh = getattr(server, "devices_per_mesh", 1)
        self.meshes = len(getattr(server, "workers", [])) or 1
        self._draining = threading.Event()
        self._drained = threading.Event()  # server closed, results sent
        self._done = threading.Event()
        self._drain_lock = threading.Lock()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name="repro-torch-fabric-accept",
            daemon=True,
        )
        self._accept_thread.start()
        self._hb_thread: Optional[threading.Thread] = None
        if frontdoor is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name="repro-torch-fabric-heartbeat",
                daemon=True,
            )
            self._hb_thread.start()

    # -- RPC serving ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed by drain
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
        send_lock = threading.Lock()
        try:
            while True:
                msg = recv_msg(conn)
                if msg is None:
                    return
                self._handle(conn, send_lock, msg)
        except (OSError, protocol.ProtocolError, json.JSONDecodeError):
            return  # peer went away mid-frame; its futures die with it
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
            self._handle_partition(conn, send_lock, msg)
        elif op in ("ping", "status"):
            resp = {
                "op": "pong",
                "server_id": self.server_id,
                "draining": self._draining.is_set(),
                "stats": self._server.stats(),
            }
            self._send(conn, send_lock, resp)
        elif op == "drain":
            resp = {"op": "draining", "server_id": self.server_id}
            self._send(conn, send_lock, resp)
            threading.Thread(target=self.drain, daemon=True).start()
        else:
            resp = {"op": "error", "detail": f"unknown op {op!r}"}
            self._send(conn, send_lock, resp)

    def _handle_partition(self, conn, send_lock, msg: Dict[str, Any]) -> None:
        rid = msg.get("id")

        def reply_error(code: str, detail: str) -> None:
            res = protocol.error_result(code, detail)
            frame = {"op": "result", "id": rid, "result": res}
            self._send(conn, send_lock, frame)

        if self._draining.is_set():
            reply_error(
                "server_closed", f"worker {self.server_id} is draining"
            )
            return
        try:
            req = protocol.decode_request(msg["request"])
            fut = self._server.submit(
                req,
                priority=int(msg.get("priority", 0)),
                deadline_s=msg.get("deadline_s"),
                timeout_s=msg.get("timeout_s"),
            )
        except protocol.ProtocolError as exc:  # bad frame is data
            reply_error("rejected", str(exc))
            return
        except RuntimeError as exc:  # server closed under us
            reply_error("server_closed", str(exc))
            return
        except Exception as exc:  # malformed request is data, not a crash
            reply_error("rejected", f"{type(exc).__name__}: {exc}")
            return

        def on_done(f) -> None:
            try:
                sr = f.result()
                wire = protocol.encode_serve_result(sr, self.server_id)
            except Exception as exc:
                wire = protocol.error_result(
                    "worker_failed", f"{type(exc).__name__}: {exc}"
                )
            frame = {"op": "result", "id": rid, "result": wire}
            self._send(conn, send_lock, frame)

        fut.add_done_callback(on_done)

    def _send(self, conn, send_lock, obj: Dict[str, Any]) -> None:
        try:
            with send_lock:
                send_msg(conn, obj)
        except OSError:
            pass  # peer gone; the front door re-routes on its side

    # -- heartbeats ----------------------------------------------------

    def _register_msg(self) -> Dict[str, Any]:
        server = {
            "server_id": self.server_id,
            "host": self.host,
            "port": self.port,
            "devices": self.devices_per_mesh,
            "meshes": self.meshes,
            "pid": os.getpid(),
        }
        return {"op": "register", "server": server}

    def _heartbeat_loop(self) -> None:
        """Register, then renew every beat; reconnect (and re-register)
        with backoff when the front door drops or restarts.

        A *draining* worker keeps its lease warm: deregistering early
        would make the front door orphan and fail over the very
        in-flight work the drain is finishing. The goodbye goes out
        only once ``_drained`` is set — every result frame has been
        sent by then, so the front door has nothing left to re-route.
        """
        backoff = 0.2
        while not self._done.is_set() and not self._drained.is_set():
            sock = None
            try:
                sock = protocol.connect(*self._frontdoor, timeout=5.0)
                send_msg(sock, self._register_msg())
                recv_msg(sock)  # lease ack
                backoff = 0.2
                while not self._drained.wait(self._heartbeat_s):
                    frame = {
                        "op": "renew",
                        "server_id": self.server_id,
                        "metrics": self._server.metrics_window(),
                    }
                    send_msg(sock, frame)
                    resp = recv_msg(sock)
                    if resp is None:
                        raise OSError("front door closed the connection")
                    if resp.get("op") == "unknown_server":
                        # our lease expired (e.g. a long GC pause or a
                        # front-door restart): re-register on the spot
                        send_msg(sock, self._register_msg())
                        recv_msg(sock)
                bye = {"op": "deregister", "server_id": self.server_id}
                send_msg(sock, bye)
                return
            except (OSError, protocol.ProtocolError):
                time.sleep(backoff)
                backoff = min(2.0, backoff * 2)
            finally:
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass

    # -- lifecycle -----------------------------------------------------

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (handler returns
        immediately; the drain runs on its own thread so in-flight
        partitions finish off the signal stack)."""

        def _on_signal(signum, frame) -> None:
            threading.Thread(target=self.drain, daemon=True).start()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def drain(self) -> None:
        """Refuse new admissions, finish in-flight attempts, resolve
        still-queued tickets as ``server_closed`` (their result frames
        still flow back), deregister, then release ``wait()``."""
        with self._drain_lock:
            if self._draining.is_set():
                self._done.wait()
                return
            self._draining.set()
        # close(wait=True) resolves queued tickets with server_closed
        # and joins in-flight attempts; every resolution fires its
        # done-callback, which sends the result frame before we close
        # the connections below
        self._server.close(wait=True)
        self._drained.set()  # heartbeat thread now deregisters and exits
        try:
            self._listener.close()
        except OSError:
            pass
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2 * self._heartbeat_s + 5.0)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a drain completes (the worker main loop)."""
        return self._done.wait(timeout)

    def __enter__(self) -> "FabricWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
