"""Client for the fabric front door — port of ``repro.fabric.client``.

One persistent connection, many outstanding requests: ``submit``
returns a future immediately and a reader thread matches ``result``
frames back by id, so a client drives the whole fleet's concurrency
without threads of its own. Results decode to
:class:`protocol.FabricResult` — errors are data, and a dead
connection resolves every outstanding future with a structured
``connection_lost`` error instead of raising from a background thread.
"""

from __future__ import annotations

import json
import socket
import threading
from concurrent.futures import Future
from typing import Any, Dict, Iterable, List, Optional

from . import protocol
from .protocol import FabricResult, recv_msg, send_msg


class FabricClient:
    """Submit partition requests to a :class:`fabric.FrontDoor`."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        connect_timeout: float = 10.0,
    ):
        self.host, self.port = host, port
        self._sock = protocol.connect(host, port, timeout=connect_timeout)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._futures: Dict[int, "Future[FabricResult]"] = {}
        self._next_id = 0
        self._closed = False
        self._reader = threading.Thread(
            target=self._recv_loop,
            name="repro-torch-fabric-client",
            daemon=True,
        )
        self._reader.start()

    def _recv_loop(self) -> None:
        err = "front door closed the connection"
        try:
            while True:
                msg = recv_msg(self._sock)
                if msg is None:
                    break
                if msg.get("op") != "result":
                    continue
                with self._lock:
                    fut = self._futures.pop(msg.get("id"), None)
                if fut is not None:
                    self._set(fut, protocol.decode_result(msg["result"]))
        except (OSError, protocol.ProtocolError, json.JSONDecodeError) as exc:
            err = f"{type(exc).__name__}: {exc}"
        with self._lock:
            orphans = list(self._futures.values())
            self._futures.clear()
        lost = protocol.decode_result(
            protocol.error_result(protocol.ERR_CONNECTION, err)
        )
        for fut in orphans:
            self._set(fut, lost)

    @staticmethod
    def _set(fut: Future, res: FabricResult) -> None:
        try:
            fut.set_result(res)
        except Exception:
            pass  # cancelled by the caller

    def submit(
        self,
        request,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        timeout_s: Optional[float] = None,
    ) -> "Future[FabricResult]":
        """Admit one request; resolves to a :class:`FabricResult`."""
        fut: "Future[FabricResult]" = Future()
        with self._lock:
            if self._closed:
                res = protocol.error_result(
                    protocol.ERR_CONNECTION, "client closed"
                )
                self._set(fut, protocol.decode_result(res))
                return fut
            rid = self._next_id
            self._next_id += 1
            self._futures[rid] = fut
        frame = {
            "op": "partition",
            "id": rid,
            "request": protocol.encode_request(request),
            "priority": priority,
            "deadline_s": deadline_s,
            "timeout_s": timeout_s,
        }
        try:
            with self._send_lock:
                send_msg(self._sock, frame)
        except OSError as exc:
            with self._lock:
                self._futures.pop(rid, None)
            res = protocol.error_result(
                protocol.ERR_CONNECTION, f"send failed: {exc}"
            )
            self._set(fut, protocol.decode_result(res))
        return fut

    def serve(self, requests: Iterable, **submit_kw) -> List[FabricResult]:
        """Admit a batch and block for all results, in request order."""
        futures = [self.submit(r, **submit_kw) for r in requests]
        return [f.result() for f in futures]

    def status(self) -> Dict[str, Any]:
        """Front-door status snapshot (a fresh short-lived connection,
        so it works even while this client's pipe is saturated)."""
        return status_of(self.host, self.port)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=2.0)

    def __enter__(self) -> "FabricClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def status_of(host: str, port: int, timeout: float = 10.0) -> Dict[str, Any]:
    """One-shot status query against a front door."""
    sock = protocol.connect(host, port, timeout=timeout)
    try:
        send_msg(sock, {"op": "status"})
        resp = recv_msg(sock)
        if resp is None:
            raise protocol.ProtocolError(
                "front door closed before replying to status"
            )
        return resp
    finally:
        sock.close()
