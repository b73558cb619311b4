"""Shape-bucketed batched dispatch for the serving tier — the JAX
package's ``serve/batching.py`` on torch.

Requests land in **shape buckets** keyed by ``(padded_n, padded_m, k,
backend)`` on geometric padding ladders; the dispatcher pops up to
``batch_max`` same-bucket tickets and a worker serves the whole batch as
ONE unit of work. Two mechanisms amortize cost inside a batch, both
bit-identical to solo ``Partitioner.run``:

1. **Coalescing** — a ``PartitionRequest`` is a pure function of its
   fields (graph spec, k, config, *seed*), so identical requests in a
   batch share one partition run.

2. **Stacked level-0 clustering** — distinct requests whose chunk slabs
   share a ``(num_chunks, iterations)`` signature (and a kernel mode)
   run their level-0 LP clustering together, the result re-entering
   each request's solo driver via ``level0_labels``. On the card
   (``kernel="fused"``) chunk ``b`` of every request is one call of the
   ``lp_move`` kernel with a request axis
   (``kernels/lp_move/ops.py::cluster_iteration_fused_stacked``); the
   composed form (``core/lp.py::cluster_iteration_stacked``) applies the
   solo body row by row. Rows are padded to the group's shape; padding
   is inert:

     * padded vertices are weight-0 singletons with no arcs — they never
       move and no real vertex adopts them (sentinel arcs and ``-1``
       lanes carry weight 0);
     * per-request slab construction (seeded degree-bucket reorder,
       chunk boundaries) stays on the host exactly as in a solo run;
     * the kernels are integer-only, so no float reassociation exists to
       break bit-identity.

   ``stack="auto"`` enables it on a CUDA device only (torch ops on the
   CPU gain nothing from stacking), ``"on"``/``"off"`` force it. A
   stacked call that cannot build or launch raises; nothing falls back
   to solo calls.

``pad_graph`` / ``remove_padding`` are the graph-level analogues of the
saxml helpers: padded vertices are weight-0 and isolated, so any
assignment's cut and block weights are untouched. The execution path
pads at the chunk-slab level instead, because whole-graph padding would
shift the host-side reorder RNG and break solo bit-identity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.backends import is_batchable, resolve_backend
from ..api.request import GraphSpec, PartitionRequest
from ..graphs.format import Graph

# ladder floors: tiny requests share one bucket instead of fragmenting
# the cache across near-identical shapes
_MIN_PAD_N = 256
_MIN_PAD_M = 1024


def pad_dim(x: int, floor: int = 1) -> int:
    """Geometric (power-of-two) padding ladder, the rung
    ``lp.build_chunks`` pads to: the smallest power of two >= max(x,
    floor)."""
    x = max(int(x), int(floor), 1)
    return 1 << (x - 1).bit_length()


class BucketKey(NamedTuple):
    """Dispatch bucket of a batchable request. Requests in one bucket
    pad to the same rung of the shape ladder, so batching them trades no
    extra padding."""

    padded_n: int
    padded_m: int
    k: int
    backend: str


def _graph_dims(graph) -> Tuple[int, int]:
    if isinstance(graph, GraphSpec):
        # directed arc count of the materialized graph is ~n * avg_deg;
        # the ladder only needs the rung, not the exact count
        return graph.n, int(graph.n * graph.avg_deg)
    return graph.n, graph.m


def bucket_of(req: PartitionRequest) -> Optional[BucketKey]:
    """The request's dispatch bucket, or None when it must stay on the
    solo serve path (non-batchable backend, or a multi-device ask)."""
    n, m = _graph_dims(req.graph)
    backend = resolve_backend(req, n)
    if not is_batchable(backend) or req.devices != 1:
        return None
    return BucketKey(padded_n=pad_dim(n, _MIN_PAD_N),
                     padded_m=pad_dim(m, _MIN_PAD_M), k=req.k,
                     backend=backend)


def request_fingerprint(req: PartitionRequest) -> tuple:
    """Hashable identity of a request's *result*: equal fingerprints are
    guaranteed equal results (requests are pure functions of their
    fields). Raw ``Graph`` payloads key by object identity — a
    conservative stand-in for content equality."""
    key = []
    for f in dataclasses.fields(req):
        v = getattr(req, f.name)
        if f.name == "graph" and not isinstance(v, GraphSpec):
            v = ("graph-id", id(v))
        key.append((f.name, v))
    return tuple(key)


def distinct_count(requests: Sequence[PartitionRequest]) -> int:
    """Number of distinct results a batch needs (metrics accounting)."""
    return len({request_fingerprint(r) for r in requests})


# ---------------------------------------------------------------------------
# Graph-level padding (saxml remove_padding idiom)
# ---------------------------------------------------------------------------

def pad_graph(g: Graph, n_pad: int) -> Graph:
    """Pad ``g`` to ``n_pad`` vertices with weight-0 isolated vertices.

    The padding is inert for partitioning metrics: isolated vertices
    contribute no arcs (cut unchanged) and zero weight (block weights
    unchanged) whatever block an assignment puts them in. The padded
    graph intentionally fails ``validate()`` (which requires vweights
    >= 1) — it is a batching artifact, not a model input."""
    if n_pad < g.n:
        raise ValueError(f"n_pad ({n_pad}) < graph n ({g.n})")
    if n_pad == g.n:
        return g
    extra = n_pad - g.n
    pad_ptr = np.full(extra, g.indptr[-1], dtype=g.indptr.dtype)
    pad_w = np.zeros(extra, dtype=g.vweights.dtype)
    return Graph(indptr=np.concatenate([g.indptr, pad_ptr]),
                 adjncy=g.adjncy, eweights=g.eweights,
                 vweights=np.concatenate([g.vweights, pad_w]))


def remove_padding(assignment: np.ndarray, n: int) -> np.ndarray:
    """Slice a padded-graph assignment back to the real vertices."""
    return np.asarray(assignment)[:n]


# ---------------------------------------------------------------------------
# Stacked level-0 clustering
# ---------------------------------------------------------------------------

def stack_enabled(stack: str, device: torch.device) -> bool:
    """Resolve the ``stack`` knob for a session on ``device``: ``"auto"``
    is on iff the device is CUDA, where chunk b of every request is one
    kernel call; torch ops on the CPU run a stacked batch as slowly as
    the rows back to back."""
    if stack == "on":
        return True
    if stack == "off":
        return False
    return torch.device(device).type == "cuda"


def _stacked_composed(rows, num_chunks: int, num_iterations: int, dev):
    """Level-0 labels (S, n_pad + 1) of a group of arc-slab requests."""
    from ..core import lp
    from ..core.coarsening import cluster_seed

    n_pad = max(ch.n_pad for _, _, _, ch in rows)
    m_pad = max(ch.w.shape[1] for _, _, _, ch in rows)
    S = len(rows)
    src = np.full((S, num_chunks, m_pad), n_pad, dtype=np.int32)
    dst = np.full((S, num_chunks, m_pad), n_pad, dtype=np.int32)
    w = np.zeros((S, num_chunks, m_pad), dtype=np.int32)
    vw = np.zeros((S, n_pad + 1), dtype=np.int32)
    for s, (_, _, g2, ch) in enumerate(rows):
        mp = ch.w.shape[1]
        # a row's own sentinel id (its n_pad) is a *real* slot under the
        # group's larger n_pad: remap it (real ids are < n <= row n_pad)
        src[s, :, :mp] = np.where(ch.src == ch.n_pad, n_pad, ch.src)
        dst[s, :, :mp] = np.where(ch.dst == ch.n_pad, n_pad, ch.dst)
        w[s, :, :mp] = ch.w
        vw[s, :g2.n] = g2.vweights
    Ws = [max(1, plan["W"]) for plan, _, _, _ in rows]
    labels = torch.arange(n_pad + 1, dtype=torch.int32,
                          device=dev).repeat(S, 1)
    vw_t = torch.from_numpy(vw).to(dev)
    cluster_w = vw_t.clone()
    src_t, dst_t, w_t = (torch.from_numpy(x).to(dev) for x in (src, dst, w))
    for it in range(num_iterations):
        seeds = [cluster_seed(plan["seed"], it) for plan, _, _, _ in rows]
        labels, cluster_w = lp.cluster_iteration_stacked(
            labels, cluster_w, src_t, dst_t, w_t, vw_t, Ws, seeds, n=n_pad)
    return labels


def _stacked_fused(rows, num_chunks: int, num_iterations: int, dev):
    """Level-0 labels (S, n_pad + 1) of a group of ELL-slab requests: one
    stacked ``lp_move`` call a chunk step."""
    from ..core import lp
    from ..core.coarsening import cluster_seed
    from ..kernels.lp_move import ops as move_ops
    from ..kernels.lp_move.lp_move import check_stack_limits

    chunks = [ch for _, _, _, ch in rows]
    n_pad = max(ch.n_pad for ch in chunks)
    N = n_pad + 1
    R = max(ch.idx.shape[1] for ch in chunks)
    D = max(ch.idx.shape[2] for ch in chunks)
    S, B = len(rows), num_chunks
    check_stack_limits(S, R, N, D)
    need = move_ops.stacked_bytes(S, B, R, D, N)
    if dev.type == "cuda":
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise RuntimeError(
                f"stacked level-0 clustering: {S} requests' slabs need "
                f"{need} bytes (B={B}, R={R}, D={D}); the card has {free} "
                "free")
    # the group's slabs on the device, each request's copied into its
    # corner; the padding (-1 lanes, weight 0) is inert
    idx_t = torch.full((B, S, R, D), -1, dtype=torch.int32, device=dev)
    w_t = torch.zeros((B, S, R, D), dtype=torch.int32, device=dev)
    vw = np.zeros((S, N), dtype=np.int32)
    for s, (_, _, g2, ch) in enumerate(rows):
        _, r, d = ch.idx.shape
        idx_t[:, s, :r, :d] = torch.from_numpy(ch.idx).to(dev)
        w_t[:, s, :r, :d] = torch.from_numpy(ch.w).to(dev)
        vw[s, :g2.n] = g2.vweights
    v0 = np.stack([ch.v0 for ch in chunks], axis=1).astype(np.int32)
    W = np.asarray([max(1, plan["W"]) for plan, _, _, _ in rows],
                   dtype=np.int32)
    # every iteration's per-chunk salts, (iterations, B, S) uint32 bits
    salts = np.asarray(
        [[lp.chunk_salts(B, cluster_seed(plan["seed"], it), 0x85EBCA6B)
          for plan, _, _, _ in rows] for it in range(num_iterations)],
        dtype=np.uint32).transpose(0, 2, 1)
    to = (lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    v0_t, W_t, vw_t = to(v0), to(W), to(vw)
    salts_t = to(salts.view(np.int32))
    labels = torch.arange(N, dtype=torch.int32, device=dev).repeat(S, 1)
    cluster_w = vw_t.clone()
    for it in range(num_iterations):
        labels, cluster_w = move_ops.cluster_iteration_fused_stacked(
            labels, cluster_w, idx_t, w_t, v0_t, vw_t, W_t, salts_t[it],
            n=n_pad)
    return labels


def stacked_level0_labels(graphs: Sequence[Graph], plans: Sequence[Dict], *,
                          device=None, kernel: str = "auto"
                          ) -> List[np.ndarray]:
    """Level-0 clustering labels for several (graph, plan) pairs, each
    bit-identical to ``coarsening.cluster(g, plan["W"], ...)`` of its
    entry, run as one stack per shared ``(num_chunks, iterations)``
    signature.

    ``plans`` entries come from ``deep_mgp.level0_cluster_plan``. Host
    preparation (seeded reorder, chunking) runs per request; only the
    padded slabs stack. ``kernel`` ("auto" | "fused" | "composed")
    resolves against ``device`` (the card by default) as ``cluster``'s
    does: "fused" runs the ``lp_move`` kernel's request axis on the card
    and its plain version on the CPU."""
    from ..core.coarsening import cluster_finish, cluster_prepare
    from ..kernels import dispatch

    dev = dispatch.resolve_device(device)
    mode = dispatch.resolve_kernel_mode(kernel, dev)
    prepped = []
    for g, plan in zip(graphs, plans):
        perm, g2, chunks = cluster_prepare(g, plan["num_chunks"],
                                           plan["seed"], kernel=mode)
        prepped.append((plan, perm, g2, chunks))
    groups: Dict[tuple, List[int]] = {}
    for i, (plan, _, _, chunks) in enumerate(prepped):
        sig = (chunks.num_chunks, plan["num_iterations"])
        groups.setdefault(sig, []).append(i)
    run = _stacked_fused if mode == "fused" else _stacked_composed
    out: List[Optional[np.ndarray]] = [None] * len(prepped)
    for (num_chunks, num_iterations), idxs in groups.items():
        labels = run([prepped[i] for i in idxs], num_chunks, num_iterations,
                     dev).cpu().numpy()
        for row, i in enumerate(idxs):
            plan, perm, g2, _ = prepped[i]
            out[i] = cluster_finish(labels[row], g2, perm,
                                    max(1, plan["W"]))
    return out  # type: ignore[return-value]


def _level0_hints(session, requests: Sequence[PartitionRequest], stack: str
                  ) -> List[Optional[np.ndarray]]:
    """Precomputed level-0 labels for the stack-eligible requests of a
    deduplicated batch (None entries keep the solo path). Requests stack
    by kernel mode, the one their solo run's ``cluster`` call takes."""
    from ..core.deep_mgp import level0_cluster_plan
    from ..kernels.dispatch import resolve_kernel_mode

    hints: List[Optional[np.ndarray]] = [None] * len(requests)
    device = session.device
    if len(requests) < 2 or not stack_enabled(stack, device):
        return hints
    by_mode: Dict[str, List[tuple]] = {}
    for i, req in enumerate(requests):
        eff = session._resolve_graph(req)
        override = session._engine.backend
        if override is not None and eff.backend == "auto":
            eff = dataclasses.replace(eff, backend=override)
        # only the "single" driver consumes the hint
        if resolve_backend(eff, eff.graph.n) != "single":
            continue
        cfg = eff.resolve_config()
        plan = level0_cluster_plan(eff.graph, eff.k, cfg)
        if plan is None:
            continue
        mode = resolve_kernel_mode(cfg.kernel, device)
        by_mode.setdefault(mode, []).append((i, eff.graph, plan))
    if sum(len(v) for v in by_mode.values()) < 2:
        return hints
    for mode, entries in by_mode.items():
        labels = stacked_level0_labels([g for _, g, _ in entries],
                                       [p for _, _, p in entries],
                                       device=device, kernel=mode)
        for (i, _, _), lab in zip(entries, labels):
            hints[i] = lab
    return hints


# ---------------------------------------------------------------------------
# Batch execution
# ---------------------------------------------------------------------------

def run_coalesced(session, requests: Sequence[PartitionRequest],
                  stack: str = "auto") -> List[object]:
    """Serve a same-bucket batch through ``session``, returning
    ``PartitionResult``s in request order, each bit-identical to a solo
    ``Partitioner.run`` of its request.

    Identical requests (by :func:`request_fingerprint`) share one run;
    distinct stack-eligible requests share one stacked level-0
    clustering. Runs on the session's executor thread — callers go
    through ``PartitionSession.submit_many``."""
    groups: Dict[tuple, List[int]] = {}
    order: List[tuple] = []
    for i, req in enumerate(requests):
        fp = request_fingerprint(req)
        if fp not in groups:
            groups[fp] = []
            order.append(fp)
        groups[fp].append(i)
    distinct = [requests[groups[fp][0]] for fp in order]
    hints = _level0_hints(session, distinct, stack)
    out: List[object] = [None] * len(requests)
    for fp, req, hint in zip(order, distinct, hints):
        res = session._run_one(req, level0_labels=hint)
        for i in groups[fp]:
            out[i] = res
    return out
