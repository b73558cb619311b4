"""Registry of the real entry points the verifier tapes.

The JAX package's 19 entries, by name, over the same tiny graph (rgg2d
240, seed 1, sharded over P PEs) and the same inputs: k = 4, a random
partition, an all-in-one-block start ``part0`` (infeasible against
``lvec``, so the balancers cannot return before a round) and a
duplicate-heavy arc set for the dedup (``seg_merge``) entry. The
variant axes are the reference's: weight-table layout (``replicated``
vs ``owner``), kernel mode (``composed`` torch ops vs ``fused`` CUDA
kernels) and, for the host entries, the callee the entry reaches.

The six host entries patch the reference's callee attributes, which the
port keeps. The port has no ``_build_*_fn`` builders (its engine is SPMD
host code over a process group, ``dist/``), so each of the 13 ``dist_*``
entries patches its public call and tapes all of it: it runs in every
rank of a ``PeMesh`` of P ranks (:func:`collect`), under the rank's
tape and collective log (``collectives_pass``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from . import tracing
from .findings import rel_to_repo


class Spec(NamedTuple):
    name: str
    module: Any
    attr: str                          # the patched callee
    invoke: Callable[[], Any]
    dist: bool                         # runs on every rank of a mesh

    @property
    def site(self) -> Tuple[str, str]:
        """(repo-relative file, function) of the patched callee."""
        return (rel_to_repo(getattr(self.module, "__file__", "")),
                self.attr)


class EntryRun(NamedTuple):
    """One entry's run on one process: its tape's ops, the collectives
    its log saw, and the lockstep mismatch that abandoned it (if one
    did)."""

    name: str
    site: Tuple[str, str]
    rank: int                          # -1: the owner (a host entry)
    ops: List[tracing.Op]
    collectives: List[tuple]
    unlogged: List[tuple]
    mismatch: Optional[tuple]


@functools.lru_cache(maxsize=4)
def _inputs(P: int) -> dict:
    from ..core.coarsening import enforce_cluster_weights
    from ..graphs import generators
    from ..graphs.distribute import distribute_graph

    g = generators.make("rgg2d", 240, 6.0, seed=1)
    k = 4
    total = int(g.total_vweight)
    rng = np.random.default_rng(3)
    part = rng.integers(0, k, size=g.n).astype(np.int64)
    labels = rng.integers(0, max(2, k), size=g.n).astype(np.int64)
    W = max(4, total // 8)
    return dict(
        g=g, shards=distribute_graph(g, P), W=W, part=part,
        part0=np.zeros(g.n, dtype=np.int64),
        lvec=np.full(k, max(1, (total + k - 1) // k + 1), dtype=np.int64),
        labels=labels,
        labels_enf=enforce_cluster_weights(labels.copy(),
                                           np.asarray(g.vweights), W),
        csrc=np.array([0, 1, 1, 2, 0, 2, 1], dtype=np.int64),
        cdst=np.array([1, 0, 2, 1, 1, 2, 2], dtype=np.int64),
        cw=np.ones(7, dtype=np.int64))


def build_specs(P: int = 2, device=None, pe=None) -> List[Spec]:
    """The 19 entries over the tiny graph sharded across ``P`` PEs: the
    host ones run on ``device``, the ``dist_*`` ones on ``pe`` (this
    rank's ``PeGroup``)."""
    from ..core import balance as c_balance
    from ..core import coarsening as c_coarsening
    from ..core import contraction as c_contraction
    from ..core import lp as c_lp
    from ..core import unconstrained as c_unconstrained
    from ..dist import dist_balance, dist_contraction, dist_lp
    from ..kernels.bal_round import ops as bal_ops
    from ..kernels.lp_move import ops as move_ops
    from ..kernels.seg_merge import ops as seg_ops

    x = _inputs(P)
    g, shards, W = x["g"], x["shards"], x["W"]
    part, part0, lvec = x["part"], x["part0"], x["lvec"]

    def cluster(weights="replicated", kernel="composed"):
        return lambda: dist_lp.dist_cluster(
            shards, W, num_iterations=1, num_chunks=2, seed=0,
            use_grid=True, pe=pe, weights=weights, kernel=kernel)

    def refine(weights):
        return lambda: dist_lp.dist_lp_refine(
            shards, part, lvec, num_iterations=1, num_chunks=2, seed=0,
            use_grid=True, pe=pe, weights=weights)

    def urefine(weights):
        return lambda: dist_lp.dist_ulp_refine(
            shards, part, lvec, num_iterations=2, num_chunks=2, seed=0,
            use_grid=True, pe=pe, weights=weights)

    def rebalance(weights="replicated", kernel="composed"):
        return lambda: dist_balance.dist_rebalance(
            shards, part0, lvec, seed=1, use_grid=True, pe=pe,
            weights=weights, kernel=kernel)

    def contract(kernel):
        return lambda: dist_contraction.dist_contract(
            shards, x["labels_enf"], use_grid=True, pe=pe, kernel=kernel)

    def host_cluster(kernel):
        return lambda: c_coarsening.cluster(
            g, W, num_iterations=1, num_chunks=2, seed=0, kernel=kernel,
            device=device)

    def host_balance(kernel):
        return lambda: c_balance.rebalance(
            g, part0.copy(), lvec, seed=3, kernel=kernel, device=device)

    return [
        Spec("dist_cluster.replicated", dist_lp, "dist_cluster",
             cluster("replicated"), True),
        Spec("dist_cluster.owner", dist_lp, "dist_cluster",
             cluster("owner"), True),
        Spec("dist_cluster.fused", dist_lp, "dist_cluster",
             cluster("replicated", kernel="fused"), True),
        Spec("dist_refine.replicated", dist_lp, "dist_lp_refine",
             refine("replicated"), True),
        Spec("dist_refine.owner", dist_lp, "dist_lp_refine",
             refine("owner"), True),
        Spec("dist_urefine.replicated", dist_lp, "dist_ulp_refine",
             urefine("replicated"), True),
        Spec("dist_urefine.owner", dist_lp, "dist_ulp_refine",
             urefine("owner"), True),
        Spec("dist_balance.replicated", dist_balance, "dist_rebalance",
             rebalance("replicated"), True),
        Spec("dist_balance.owner", dist_balance, "dist_rebalance",
             rebalance("owner"), True),
        Spec("dist_balance.fused", dist_balance, "dist_rebalance",
             rebalance("replicated", kernel="fused"), True),
        Spec("dist_enforce", dist_balance, "dist_enforce_cluster_weights",
             lambda: dist_balance.dist_enforce_cluster_weights(
                 shards, x["labels"], W, use_grid=True, pe=pe), True),
        Spec("dist_contract.composed", dist_contraction, "dist_contract",
             contract("composed"), True),
        Spec("dist_contract.fused", dist_contraction, "dist_contract",
             contract("fused"), True),
        Spec("host_cluster.composed", c_lp, "cluster_iteration",
             host_cluster("composed"), False),
        Spec("host_cluster.fused", move_ops, "cluster_iteration_fused",
             host_cluster("fused"), False),
        Spec("host_urefine", c_unconstrained, "urefine_iteration",
             lambda: c_unconstrained.unconstrained_refine(
                 g, part.copy(), lvec, num_iterations=2, num_chunks=2,
                 seed=0, device=device), False),
        Spec("host_balance.composed", c_balance, "balance_round",
             host_balance("composed"), False),
        Spec("host_balance.fused", bal_ops, "balance_round_fused",
             host_balance("fused"), False),
        Spec("host_dedup.fused", seg_ops, "seg_merge",
             lambda: c_contraction.dedup_arcs(
                 x["csrc"], x["cdst"], x["cw"], kernel="fused",
                 device=device), False),
    ]


def run_host(spec: Spec) -> EntryRun:
    """Tape one host entry in this process."""
    tape = tracing.capture(spec.module, spec.attr, spec.invoke)
    return EntryRun(spec.name, spec.site, -1, tape.ops, [], tape.unlogged,
                    None)


def trace_on_rank(pe, P: int, names: Tuple[str, ...]) -> List[EntryRun]:
    """``PeMesh.call`` target: tape the named ``dist_*`` entries on this
    rank, then gather every rank's runs (the same list on every rank)."""
    from . import collectives_pass
    specs = {s.name: s for s in build_specs(P, pe.device, pe)}
    return collectives_pass.run_on_rank(pe, [specs[n] for n in names])


def collect(P: int = 2, device=None, mesh=None) -> List[EntryRun]:
    """Tape every entry: the host ones here on ``device``, the
    ``dist_*`` ones on every rank of ``mesh`` (a ``PeMesh`` of P
    ranks). Returns the runs, host entries once and ``dist_*`` entries
    once a rank, in the registry's order."""
    specs = build_specs(P, device)
    names = tuple(s.name for s in specs if s.dist)
    dist_runs = mesh.call(trace_on_rank, P, names).value if names else []
    by_name: dict = {}
    for run in dist_runs:
        by_name.setdefault(run.name, []).append(run)
    out: List[EntryRun] = []
    for spec in specs:
        out.extend(by_name[spec.name] if spec.dist else [run_host(spec)])
    return out
