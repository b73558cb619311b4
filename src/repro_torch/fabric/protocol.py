"""Wire protocol for the cross-process serving fabric.

Port of ``repro.fabric.protocol``, with the same frame layout: a client
or worker of either package reads the other's frames.

Length-prefixed JSON over TCP — a 4-byte big-endian length header
followed by a UTF-8 JSON object. No external dependencies beyond
numpy: framing and codecs are standard library, and nothing here
touches a CUDA device — the front door routes without owning devices.
The codecs import the port's own ``api.request``, ``core.deep_mgp``
and ``graphs.format`` when they run.

Every frame is one JSON object carrying an ``"op"`` key:

  client -> front door   ``partition`` / ``status``
  front door -> client   ``result`` / ``status``
  worker -> front door   ``register`` / ``renew`` / ``deregister``
  front door -> worker   ``lease`` / ``unknown_server`` (heartbeats),
                         ``partition`` / ``drain`` (work connection)
  worker -> front door   ``result`` (work connection)

``PartitionRequest`` objects cross the wire losslessly:
``GraphSpec`` graphs as their (hashable) fields, in-memory ``Graph``
objects as base64-encoded raw arrays — so fabric results stay
bit-identical to solo ``repro_torch.api.Partitioner.run`` on the same
request.
Assignments come back the same way (dtype + shape + base64 payload).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import socket
import struct
from typing import Any, Dict, Optional

import numpy as np

MAX_FRAME = 1 << 30  # 1 GiB — sanity bound, not a protocol limit

# structured error the client synthesizes when a connection dies with
# requests still outstanding (the fabric analogue of a lost worker)
ERR_CONNECTION = "connection_lost"


class ProtocolError(RuntimeError):
    """A malformed or truncated frame."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def send_msg(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Send one frame (atomic via a single ``sendall``)."""
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(data) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(data)} bytes exceeds MAX_FRAME")
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Receive one frame; None on clean EOF at a frame boundary."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ProtocolError(f"frame of {length} bytes exceeds MAX_FRAME")
    data = _recv_exact(sock, length)
    if data is None:
        raise ProtocolError("connection closed mid-frame")
    return json.loads(data.decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes; None on EOF before the first byte (a clean
    close at a frame boundary), ProtocolError on EOF mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def connect(
    host: str,
    port: int,
    timeout: Optional[float] = None,
) -> socket.socket:
    """Dial a fabric endpoint (TCP_NODELAY — frames are small and
    latency-sensitive; the payload b64 dominates large ones anyway)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


# ---------------------------------------------------------------------------
# array / request / result codecs
# ---------------------------------------------------------------------------


def encode_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {
        "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    return arr.reshape(d["shape"]).copy()


def encode_request(req) -> Dict[str, Any]:
    """``PartitionRequest`` -> wire dict (lossless)."""
    from ..api.request import GraphSpec

    g = req.graph
    if isinstance(g, GraphSpec):
        graph = {
            "kind": "spec",
            "family": g.family,
            "n": g.n,
            "avg_deg": g.avg_deg,
            "seed": g.seed,
        }
    else:
        graph = {
            "kind": "graph",
            "indptr": encode_array(g.indptr),
            "adjncy": encode_array(g.adjncy),
            "eweights": encode_array(g.eweights),
            "vweights": encode_array(g.vweights),
        }
    cfg = None if req.config is None else dataclasses.asdict(req.config)
    return {
        "graph": graph,
        "k": req.k,
        "epsilon": req.epsilon,
        "preset": req.preset,
        "config": cfg,
        "seed": req.seed,
        "backend": req.backend,
        "devices": req.devices,
        "collect_trace": req.collect_trace,
        "contraction": req.contraction,
        "weights": req.weights,
        "balance": req.balance,
        "kernel": req.kernel,
        "refine": req.refine,
        "quality": req.quality,
    }


def decode_request(d: Dict[str, Any]):
    """Wire dict -> ``PartitionRequest`` (validated by the caller)."""
    from ..core.deep_mgp import PartitionerConfig
    from ..graphs.format import Graph
    from ..api.request import GraphSpec, PartitionRequest

    g = d["graph"]
    if g["kind"] == "spec":
        graph = GraphSpec(
            family=g["family"],
            n=int(g["n"]),
            avg_deg=float(g["avg_deg"]),
            seed=int(g["seed"]),
        )
    elif g["kind"] == "graph":
        graph = Graph(
            indptr=decode_array(g["indptr"]),
            adjncy=decode_array(g["adjncy"]),
            eweights=decode_array(g["eweights"]),
            vweights=decode_array(g["vweights"]),
        )
    else:
        raise ProtocolError(f"unknown graph kind {g.get('kind')!r}")
    cfg = d.get("config")
    return PartitionRequest(
        graph=graph,
        k=int(d["k"]),
        epsilon=float(d["epsilon"]),
        preset=d["preset"],
        config=None if cfg is None else PartitionerConfig(**cfg),
        seed=int(d["seed"]),
        backend=d["backend"],
        devices=int(d["devices"]),
        collect_trace=bool(d["collect_trace"]),
        contraction=d.get("contraction"),
        weights=d.get("weights"),
        balance=d.get("balance"),
        kernel=d.get("kernel"),
        refine=d.get("refine"),
        quality=d.get("quality"),
    )


def _jsonable(x):
    """Recursively strip numpy scalar types out of a metrics dict."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def encode_serve_result(sr, server_id: Optional[str] = None) -> Dict[str, Any]:
    """``repro_torch.serve.ServeResult`` -> wire dict, carrying the assignment
    so clients can assert bit-identity against solo runs."""
    out: Dict[str, Any] = {
        "ok": bool(sr.ok),
        "error": sr.error,
        "detail": sr.detail,
        "server": server_id,
        "worker": sr.worker,
        "attempts": int(sr.attempts),
        "priority": int(sr.priority),
        "queue_wait_s": float(sr.queue_wait_s),
        "total_s": float(sr.total_s),
    }
    if sr.ok and sr.result is not None:
        r = sr.result
        out.update(
            {
                "assignment": encode_array(r.assignment),
                "cut": int(r.cut),
                "feasible": bool(r.feasible),
                "backend": r.backend,
                "time_s": float(r.time_s),
                "metrics": _jsonable(r.metrics),
            }
        )
    return out


@dataclasses.dataclass(frozen=True)
class FabricResult:
    """Client-side view of one fabric response — the cross-process
    analogue of ``ServeResult`` (errors are data, never exceptions)."""

    ok: bool
    error: Optional[str]
    detail: str
    server: Optional[str]  # server id that produced the result
    worker: Optional[int]  # mesh worker inside that server
    attempts: int  # front-door level attempts (servers tried)
    assignment: Optional[np.ndarray] = None
    cut: Optional[int] = None
    feasible: Optional[bool] = None
    backend: Optional[str] = None
    time_s: float = 0.0
    metrics: Optional[Dict[str, Any]] = None

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "ok": self.ok,
            "server": self.server,
            "attempts": self.attempts,
        }
        if self.ok:
            out.update(
                {
                    "cut": self.cut,
                    "feasible": self.feasible,
                    "backend": self.backend,
                    "time_s": round(self.time_s, 4),
                }
            )
        else:
            out.update({"error": self.error, "detail": self.detail})
        return out


def decode_result(d: Dict[str, Any]) -> FabricResult:
    asg = d.get("assignment")
    return FabricResult(
        ok=bool(d["ok"]),
        error=d.get("error"),
        detail=d.get("detail", ""),
        server=d.get("server"),
        worker=d.get("worker"),
        attempts=int(d.get("attempts", 0)),
        assignment=None if asg is None else decode_array(asg),
        cut=d.get("cut"),
        feasible=d.get("feasible"),
        backend=d.get("backend"),
        time_s=float(d.get("time_s", 0.0)),
        metrics=d.get("metrics"),
    )


def error_result(code: str, detail: str, attempts: int = 0) -> Dict[str, Any]:
    """Wire dict for a front-door-synthesized structured error."""
    return {
        "ok": False,
        "error": code,
        "detail": detail,
        "server": None,
        "worker": None,
        "attempts": attempts,
        "priority": 0,
        "queue_wait_s": 0.0,
        "total_s": 0.0,
    }
