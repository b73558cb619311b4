"""Batched serving sessions on one device — port of ``repro.api.session``.

``PartitionSession`` amortizes per-process state (the device, materialized
``GraphSpec`` graphs) across a stream of requests and runs independent
requests concurrently on a thread pool. Results are bit-identical to
running each request alone through ``Partitioner`` — every request is a
pure function of its fields.

``submit_many`` serves a same-bucket batch as one unit of work
(``serve/batching.py::run_coalesced``): identical requests share one
run, and with ``stack`` on distinct requests share one stacked level-0
clustering.

A session of ``devices`` > 1 owns a mesh (``api.runtime.PeMesh``: one
rank process a PE, built on the first distributed request) and sends
every distributed request at that PE count to its ranks, one request at
a time; everything else runs in this process, as a solo run would.
``shard_ctx`` is the model layers' handle on the session's PEs.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence

from .backends import DISTRIBUTED, BackendContext, resolve_backend
from .partitioner import Partitioner
from .request import GraphSpec, PartitionRequest
from .result import PartitionResult


class BucketCache:
    """Bounded LRU mapping for long-lived serving processes.

    Dict-shaped (``get`` / ``[]`` / ``len`` / ``in``), but capped:
    inserting beyond ``maxsize`` evicts the least-recently-used entry, so
    a diverse traffic mix cannot grow the cache without bound. Any
    hashable key works. Not thread-safe on its own; callers hold the
    cache lock."""

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self.evictions = 0
        self._data: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            value = self._data[key]
        except KeyError:
            return default
        self._data.move_to_end(key)
        return value

    def __getitem__(self, key):
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def __setitem__(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1

    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()


class PartitionSession:
    """Serve batches of ``PartitionRequest``s on one torch device.

    Parameters
    ----------
    devices:
        PE count the session's mesh is built for (once, lazily, on the
        first distributed request at that count). Requests keep their
        own ``devices`` field: one at another count runs as a solo
        ``Partitioner.run`` would (so a distributed one raises from its
        future unless this process belongs to a group of that size).
    backend:
        Optional registry name replacing each request's ``"auto"`` hint.
    max_workers:
        Thread-pool width for concurrent independent requests. Graph
        generation and the numpy phases overlap; device work runs on the
        device's current stream, so a small pool is plenty.
    mesh:
        Optional pre-built ``PeMesh`` of exactly ``devices`` ranks (the
        serving tier binds one per worker); it stays its builder's to
        close. Without it a session of ``devices`` > 1 builds its own
        over the first ``devices`` cards (or CPU ranks for
        ``device="cpu"``) and closes it with the session.
    graph_cache:
        Optional externally owned ``GraphSpec -> Graph`` mapping; when
        omitted, the session owns a :class:`BucketCache` bounded at
        ``graph_cache_size`` entries.
    graph_cache_lock:
        Lock guarding ``graph_cache``; sessions sharing one cache share
        one lock. It is held *through* the materialize on purpose:
        duplicated generator work costs seconds, a serialized miss a wait.
    graph_cache_size:
        LRU bound of the session-owned cache.
    stack:
        Stacked level-0 clustering for ``submit_many`` batches:
        ``"auto"`` (on for a CUDA device, where chunk b of every request
        is one ``lp_move`` kernel call; off on the CPU), ``"on"`` or
        ``"off"``. See ``serve/batching.py``.
    device:
        The torch device every request runs on: the card by default
        (raising without one), ``"cpu"`` on purpose.
    """

    def __init__(self, devices: int = 1, backend: Optional[str] = None,
                 max_workers: int = 4, mesh=None,
                 graph_cache: Optional[Dict[GraphSpec, object]] = None,
                 graph_cache_lock: Optional[threading.Lock] = None,
                 graph_cache_size: int = 64, stack: str = "auto",
                 device=None):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if mesh is not None and getattr(mesh, "size", None) != devices:
            raise ValueError(
                f"mesh must be a PeMesh of exactly {devices} rank(s), got "
                f"{mesh!r}")
        if stack not in ("auto", "on", "off"):
            raise ValueError(
                f"stack must be 'auto', 'on' or 'off', got {stack!r}")
        self.devices = devices
        self.stack = stack
        self._engine = Partitioner(backend=backend, device=device)
        self._graph_cache: Dict[GraphSpec, object] = \
            graph_cache if graph_cache is not None \
            else BucketCache(graph_cache_size)
        self._graph_cache_lock = graph_cache_lock if \
            graph_cache_lock is not None else threading.Lock()
        self._lock = threading.Lock()
        self._mesh = mesh
        self._mesh_lock = threading.Lock()     # held through a spawn
        self._owns_mesh = False
        self._served = 0
        self._total_time_s = 0.0
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="repro-torch-api")

    # -- shared state ------------------------------------------------------

    @property
    def mesh(self):
        """The session's ``PeMesh``: the one it was given, else built on
        first use for ``devices`` > 1; ``None`` for a single-device
        session without one."""
        with self._mesh_lock:
            if self._mesh is None and self.devices > 1:
                if self._closed:
                    raise RuntimeError("session is closed")
                from ..dist.dist_lp import make_mesh_1d
                self._mesh = make_mesh_1d(self.devices, self.device)
                self._owns_mesh = True
            return self._mesh

    @property
    def shard_ctx(self):
        """The sharding context the model layers take: ``NULL_CTX`` for
        a single-device session, else a ``ShardCtx`` over the session's
        ``pe`` axis of ``devices`` PEs (its mesh if it has one; a
        ``MeshShape`` otherwise: this spawns no rank)."""
        from ..dist.sharding import pe_ctx
        return pe_ctx(self.devices, self._mesh)

    @property
    def device(self):
        """The torch device every request of this session runs on."""
        return self._engine.device

    def _resolve_graph(self, req: PartitionRequest) -> PartitionRequest:
        """Materialize (and cache) GraphSpec graphs once per cache — the
        lock spans the materialize so concurrent misses on one spec never
        duplicate the generator work."""
        if isinstance(req.graph, GraphSpec):
            with self._graph_cache_lock:
                g = self._graph_cache.get(req.graph)
                if g is None:
                    g = req.graph.materialize()
                    self._graph_cache[req.graph] = g
            return dataclasses.replace(req, graph=g)
        return req

    # -- serving -----------------------------------------------------------

    def _run_one(self, req: PartitionRequest,
                 level0_labels=None) -> PartitionResult:
        """One request as a solo run; ``level0_labels``, when given,
        replaces its level-0 clustering (the serving tier's stacked
        labels, bit-identical to what that call returns). A distributed
        request at the session's PE count goes to the mesh."""
        spec = req.graph if isinstance(req.graph, GraphSpec) else None
        eff = req
        if self._engine.backend is not None and req.backend == "auto":
            eff = dataclasses.replace(req, backend=self._engine.backend)
        mesh = None
        if resolve_backend(eff, req.graph.n) in DISTRIBUTED and \
                req.devices == self.devices:
            mesh = self.mesh
        req = self._resolve_graph(req)
        res = self._engine.run(req, _ctx=BackendContext(
            device=self.device, devices=req.devices,
            level0_labels=level0_labels, mesh=mesh, spec=spec))
        with self._lock:
            self._served += 1
            self._total_time_s += res.time_s
        return res

    def _run_many(self, requests: List[PartitionRequest]
                  ) -> List[PartitionResult]:
        # lazy import: serve/ layers on api/, not the reverse
        from ..serve.batching import run_coalesced
        return run_coalesced(self, requests, stack=self.stack)

    def submit(self, req: PartitionRequest) -> "Future[PartitionResult]":
        """Enqueue one request; returns a future. The closed-check and the
        executor submit happen under one lock span, so a submit racing
        ``close()`` either lands before it or raises the session-closed
        error."""
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            return self._pool.submit(self._run_one, req)

    def submit_many(self, requests: Sequence[PartitionRequest]
                    ) -> "Future[List[PartitionResult]]":
        """Enqueue a same-shape-bucket batch as ONE unit of work: the
        returned future resolves to results in request order. Identical
        requests are coalesced into a single partition run (requests are
        pure functions of their fields), and — with ``stack`` on —
        distinct requests share one stacked level-0 clustering. Results
        are bit-identical to per-request ``submit``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            return self._pool.submit(self._run_many, list(requests))

    def run_batch(self, requests: Iterable[PartitionRequest]
                  ) -> List[PartitionResult]:
        """Serve a batch concurrently; results in request order.

        A mid-loop submit failure (e.g. the session closing under us)
        does not leak the already-submitted futures: they are cancelled
        where possible and awaited otherwise."""
        futures: List[Future] = []
        try:
            for r in requests:
                futures.append(self.submit(r))
        except BaseException:
            for f in futures:
                f.cancel()
            for f in futures:
                if not f.cancelled():
                    try:
                        f.result()
                    except Exception:
                        pass  # the caller gets the submit failure
            raise
        return [f.result() for f in futures]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"served": self._served,
                    "devices": self.devices,
                    "total_partition_time_s": round(self._total_time_s, 6)}

    # -- lifecycle ---------------------------------------------------------

    def close(self, wait: bool = True) -> None:
        """``wait=False`` abandons in-flight work. ``_closed`` flips under
        the lock ``submit`` holds; the pool shuts down outside it (running
        requests take the lock for stats). A mesh the session built is
        closed with it (killed, if a request still runs there)."""
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=wait)
        with self._mesh_lock:
            if self._owns_mesh:
                self._mesh.close()

    def __enter__(self) -> "PartitionSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
