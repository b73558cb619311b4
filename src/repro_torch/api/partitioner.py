"""The ``Partitioner`` facade — port of ``repro.api.partitioner``."""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..core import metrics
from ..graphs.format import Graph
from ..kernels.dispatch import resolve_device
from .backends import BackendContext, get_backend, resolve_backend
from .request import GraphSpec, PartitionRequest
from .result import PartitionResult


class Partitioner:
    """Runs ``PartitionRequest``s through the backend registry on one torch
    device.

    ``backend`` replaces the ``"auto"`` hint of incoming requests (an
    explicit per-request backend always wins). ``device`` defaults to the
    CUDA device and raises without one; ``device="cpu"`` runs on the CPU
    on purpose.
    """

    def __init__(self, backend: Optional[str] = None, device=None):
        self.backend = backend
        self.device = resolve_device(device)

    def run(self, request: PartitionRequest, *,
            _ctx: Optional[BackendContext] = None) -> PartitionResult:
        req = request
        if self.backend is not None and req.backend == "auto":
            req = dataclasses.replace(req, backend=self.backend)
        req.validate()
        g = req.resolve_graph()
        name = resolve_backend(req, g.n)
        fn = get_backend(name)
        ctx = _ctx or BackendContext(device=self.device,
                                     devices=req.devices)
        if ctx.trace is None and req.collect_trace:
            ctx.trace = []
        t0 = time.perf_counter()
        assignment = np.asarray(fn(g, req, ctx), dtype=np.int64)
        dt = time.perf_counter() - t0
        s = metrics.summarize(g, assignment, req.k, req.epsilon)
        s.update({"n": g.n, "m": g.m})
        return PartitionResult(assignment=assignment,
                               feasible=bool(s["feasible"]),
                               metrics=s, backend=name, time_s=dt,
                               trace=tuple(ctx.trace or ()), request=req)

    def run_batch(self, requests: Iterable[PartitionRequest]
                  ) -> List[PartitionResult]:
        """Sequential batch; ``PartitionSession`` runs these concurrently."""
        return [self.run(r) for r in requests]

    def compare(self, request: PartitionRequest,
                backends: Sequence[str]) -> List[PartitionResult]:
        """Run the *same* request against several backends — the
        ``--compare`` flag is exactly this. A GraphSpec is materialized
        once, not once per backend."""
        request = dataclasses.replace(request,
                                      graph=request.resolve_graph())
        return [self.run(dataclasses.replace(request, backend=b))
                for b in backends]


def partition(graph: Union[Graph, GraphSpec], k: int, device=None,
              **request_kw) -> PartitionResult:
    """One-shot convenience: build a request, run the default facade."""
    return Partitioner(device=device).run(
        PartitionRequest(graph=graph, k=k, **request_kw))
