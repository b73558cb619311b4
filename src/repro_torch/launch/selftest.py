"""Multi-device selftest of the port — the reference's
``repro.launch.selftest`` check for check, on a mesh of P rank processes.

Usage:  python -m repro_torch.launch.selftest --devices 4 --test all
        python -m repro_torch.launch.selftest --devices 2 --device cpu \\
            --n 500 --test smoke
        python -m repro_torch.launch.selftest --devices 1 --test all kernels

Where the reference forces P host devices into its own process, this
one spawns P ranks (``dist.dist_lp.make_mesh_1d``: one process a card,
or P gloo ranks with ``--device cpu``) and runs every distributed step
on them through ``PeMesh.call``; the host side of each check (the
single-process partitioner, the host contraction and balancer, the
verdicts) runs here, on ``--device``. It validates the distributed
implementation against the single-process one: collectives round-trip,
distributed clustering validity (replicated and owner-sharded weight
tables), sharded contraction invariants (``--test contract``),
distributed partition feasibility + quality under both memory models,
both refinement tiers (``--test refine``: size-constrained LP plus the
Jet-style unconstrained pass, which must end feasible after afterburner
repair and be bit-identical across weight-table layouts), the
distributed balancer (``--test balance``: P=1 bit-identity with the
host balancer, adversarial-start feasibility, sharded cluster-weight
enforcement, and the no-host-gather trace assertion for
``balance="dist"``), grid vs direct all-to-all equivalence, the
``repro_torch.api`` facade (driver equality, a batched session over the
mesh), the ``repro_torch.serve`` multi-mesh tier (``--test serve``: a
2-mesh server drains concurrent mixed-size requests bit-identically to
solo runs, a killed worker's request completes via retry on the other
mesh, and deadline expiry surfaces a structured error), and the
shape-bucketed batched dispatch (``--test batch``: a duplicate-heavy hot
mix is served in batches bit-identically to solo runs with coalescing
observed in the metrics, and the stacked level-0 clustering path —
forced on even on the CPU — reproduces solo results bit for bit), and
the hot-loop kernels (``--test kernels``, *not* part of ``all``: the
``kernel="fused"`` pipeline — the CUDA kernels on the card, their plain
versions on the CPU — must reproduce ``"composed"`` labels and cut bit
for bit on the host path and under both distributed memory models, on
its own reduced instance), and the cross-process fabric (``--test
fabric``, *not* part of ``all`` because it spawns real worker
subprocesses: a front door plus two worker processes serve
bit-identically to solo runs, a SIGKILLed worker's admitted requests
fail over to the survivor, and a SIGTERM drain finishes in-flight work
and answers queued tickets with structured errors — nothing hangs).
``--test`` takes several names. ``analysis`` (the static verifier) is
not ported: it exits 2. Prints one JSON line per test; exit code 0 iff
all pass. Runs on the card unless ``--device cpu``; without enough cards
it exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

import numpy as np

TESTS = ("all", "collectives", "halo", "cluster", "contract", "partition",
         "refine", "balance", "smoke", "api", "serve", "batch", "fabric",
         "kernels", "analysis")


def _cfg():
    from repro_torch.core.deep_mgp import PartitionerConfig
    return PartitionerConfig(contraction_limit=128, ip_repetitions=2,
                             num_chunks=4)


@functools.lru_cache(maxsize=4)
def _graph(family: str, n: int, seed: int):
    from repro_torch.graphs import generators
    return generators.make(family, n, 8.0, seed=seed)


def _every_rank(pe, obj):
    """Each rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    every = [None] * pe.P
    dist.all_gather_object(every, obj)
    return every


def _plain(o):
    """numpy scalars in a JSON line."""
    return o.item() if hasattr(o, "item") else str(o)


def _no_times(stats: dict) -> dict:
    from repro_torch.api.runtime import TIMINGS
    return {k: v for k, v in stats.items() if k not in TIMINGS}


# ---------------------------------------------------------------------------
# what the ranks run (each returns the same value on every rank)
# ---------------------------------------------------------------------------

def _rank_collectives(pe, slab):
    import torch

    from repro_torch.dist.collectives import (direct_all_to_all,
                                              grid_all_to_all)
    mine = torch.from_numpy(slab[pe.rank]).to(pe.device)
    out = {"direct": direct_all_to_all(mine, pe).cpu().numpy(),
           "grid": grid_all_to_all(mine, pe).cpu().numpy()}
    every = _every_rank(pe, out)
    return {k: np.stack([e[k] for e in every]) for k in out}


def _rank_halo(pe, gkey, vals):
    import torch

    from repro_torch.dist.collectives import halo_exchange
    from repro_torch.graphs.distribute import distribute_graph
    sh = distribute_graph(_graph(*gkey), pe.P)
    p = pe.rank

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(pe.device)

    out = {m: halo_exchange(on(vals[p]), on(sh.send_idx[p]),
                            on(sh.recv_slot[p]), sh.n_ghost, pe,
                            use_grid=m == "grid").cpu().numpy()
           for m in ("direct", "grid")}
    every = _every_rank(pe, out)
    return {k: np.stack([e[k] for e in every]) for k in out}


def _rank_cluster(pe, gkey, W):
    from repro_torch.dist.dist_lp import dist_cluster
    from repro_torch.graphs.distribute import distribute_graph
    sh = distribute_graph(_graph(*gkey), pe.P)
    kw = dict(num_iterations=3, num_chunks=4, seed=1, pe=pe)
    return (dist_cluster(sh, W, use_grid=True, **kw),
            dist_cluster(sh, W, use_grid=False, **kw),
            dist_cluster(sh, W, use_grid=True, weights="owner", **kw))


def _rank_contract(pe, gkey, W):
    from repro_torch.api.runtime import RankOutput
    from repro_torch.core.coarsening import enforce_cluster_weights
    from repro_torch.dist.dist_contraction import dist_contract
    from repro_torch.dist.dist_lp import dist_cluster
    from repro_torch.graphs.distribute import distribute_graph
    g = _graph(*gkey)
    sh = distribute_graph(g, pe.P)
    labels = enforce_cluster_weights(
        dist_cluster(sh, W, num_iterations=3, num_chunks=4, seed=1,
                     use_grid=True, pe=pe), np.asarray(g.vweights), W)
    grid = dist_contract(sh, labels, use_grid=True, pe=pe)
    direct = dist_contract(sh, labels, use_grid=False, pe=pe)
    return RankOutput((labels, grid.graph, grid.mapping,
                       _no_times(grid.stats), direct.graph, direct.mapping),
                      grid.stats)


def _rank_refine(pe, gkey, part0, lmax):
    from repro_torch.dist.dist_lp import dist_ulp_refine
    from repro_torch.dist.dist_partitioner import dist_refine_and_balance
    from repro_torch.graphs.distribute import distribute_graph
    g = _graph(*gkey)
    kw = dict(num_iterations=3, num_chunks=4, seed=3, pe=pe)
    lp = dist_refine_and_balance(g, part0, lmax, pe.P, **kw)
    ulp = dist_refine_and_balance(g, part0, lmax, pe.P,
                                  refine="unconstrained", **kw)
    sh = distribute_graph(g, pe.P)
    return (lp, ulp,
            dist_ulp_refine(sh, part0, lmax, weights="replicated", **kw),
            dist_ulp_refine(sh, part0, lmax, weights="owner", **kw))


def _rank_rebalance_p1(pe, gkey, part0, lmax):
    from repro_torch.dist.dist_balance import dist_rebalance
    from repro_torch.graphs.distribute import distribute_graph
    sh = distribute_graph(_graph(*gkey), 1)
    return dist_rebalance(sh, part0.copy(), lmax, seed=11, use_grid=False,
                          pe=pe)


def _rank_balance(pe, gkey, k, part0, lmax, labels, W, cfg):
    from repro_torch.core import metrics
    from repro_torch.dist import dist_partitioner as dp
    from repro_torch.dist.dist_balance import (dist_enforce_cluster_weights,
                                               dist_rebalance)
    from repro_torch.graphs.distribute import distribute_graph
    g = _graph(*gkey)
    P = pe.P
    shP = distribute_graph(g, P)
    bstats = {}
    out = {"fixed": dist_rebalance(shP, part0.copy(), lmax, seed=11,
                                   use_grid=True, pe=pe, stats=bstats)}
    out["stats"] = _no_times(bstats)
    out["fixed_d"] = dist_rebalance(shP, part0.copy(), lmax, seed=11,
                                    use_grid=False, pe=pe)
    out["fixed_o"] = dist_rebalance(shP, part0.copy(), lmax, seed=11,
                                    use_grid=True, weights="owner", pe=pe)
    lvec = lmax * (1 + (np.arange(k) % 2))
    out["lvec"] = lvec
    out["fixed_h"] = dist_rebalance(shP, part0.copy(), lvec, seed=13,
                                    use_grid=True, pe=pe)
    out["lab_d"] = dist_enforce_cluster_weights(shP, labels, W,
                                                use_grid=True, pe=pe)
    # the uncoarsening path with balance="dist" makes no host-side
    # rebalance gather (an instrumented counter), both table layouts
    calls = {"n": 0}
    orig = dp.rebalance

    def counting_rebalance(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    dp.rebalance = counting_rebalance
    try:
        for wmode in ("replicated", "owner"):
            calls["n"] = 0
            cfg_b = dataclasses.replace(
                cfg, balance="dist", weights=wmode,
                contraction="sharded" if wmode == "owner" else "host")
            tr = []
            part_b = dp.dist_partition_impl(g, k, P, cfg=cfg_b, trace=tr,
                                            pe=pe)
            out[wmode] = (metrics.summarize(g, part_b, k, 0.03),
                          [t["seed"] for t in tr
                           if t["phase"] == "dist-uncoarsen"], calls["n"])
        calls["n"] = 0
        dp.dist_partition_impl(g, k, P, cfg=cfg, pe=pe)
        out["host_calls"] = calls["n"]
    finally:
        dp.rebalance = orig
    return out


def _rank_partition(pe, gkey, k, cfg):
    from repro_torch.dist.dist_partitioner import dist_partition_impl
    g = _graph(*gkey)
    cfg_sh = dataclasses.replace(cfg, contraction="sharded",
                                 weights="owner")
    return (dist_partition_impl(g, k, pe.P, cfg=cfg, pe=pe),
            dist_partition_impl(g, k, pe.P, cfg=cfg_sh, pe=pe))


def _rank_api(pe, gkey, k, cfg):
    from repro_torch.api import PartitionRequest, Partitioner
    from repro_torch.dist.dist_partitioner import dist_partition_impl
    g = _graph(*gkey)
    engine = Partitioner(device=pe.device)
    res = engine.run(PartitionRequest(graph=g, k=k, config=cfg,
                                      backend="dist-grid", devices=pe.P))
    want = dist_partition_impl(g, k, pe.P, cfg=cfg, use_grid=True, pe=pe)
    auto = engine.run(PartitionRequest(graph=g, k=k, config=cfg,
                                       backend="auto", devices=pe.P))
    return (res.assignment, res.feasible, res.cut, len(res.trace), want,
            auto.backend)


def _rank_solo(pe, req):
    """A solo ``Partitioner.run`` of ``req`` on the ranks."""
    from repro_torch.api import Partitioner
    return Partitioner(device=pe.device).run(req).assignment


def _rank_kernels(pe, gkey, kk, cfg_k):
    from repro_torch.dist.dist_partitioner import dist_partition_impl
    g = _graph(*gkey)
    out = {}
    for name, contraction, weights, balance in (
            ("host_replicated", "host", "replicated", "host"),
            ("sharded_owner", "sharded", "owner", "dist")):
        for mode in ("composed", "fused"):
            cfg_d = dataclasses.replace(
                cfg_k, contraction=contraction, weights=weights,
                balance=balance, kernel=mode)
            out[name, mode] = dist_partition_impl(g, kk, pe.P, cfg=cfg_d,
                                                  pe=pe)
    return out


# ---------------------------------------------------------------------------
# the owner
# ---------------------------------------------------------------------------

def _solo_runs(reqs, device):
    """Each request alone: in this process, or on a session of its PE
    count (one mesh for all of them) for a distributed one."""
    from repro_torch.api import Partitioner, PartitionSession
    engine = Partitioner(device=device)
    sessions = {}
    try:
        out = []
        for r in reqs:
            if r.devices > 1:
                if r.devices not in sessions:
                    sessions[r.devices] = PartitionSession(
                        devices=r.devices, max_workers=1, device=device)
                out.append(sessions[r.devices].submit(r).result())
            else:
                out.append(engine.run(r))
        return out
    finally:
        for s in sessions.values():
            s.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.selftest")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--test", nargs="+", default=["all"], choices=TESTS)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--family", default="rgg2d")
    ap.add_argument("--device", default=None,
                    help="where the ranks and the host side run (default: "
                         "the cards, one a rank; 'cpu': gloo ranks)")
    args = ap.parse_args(argv)
    tests = set(args.test)
    if "analysis" in tests:
        print("selftest: the static verifier (analysis/) is not ported to "
              "repro_torch yet (ROADMAP queue 1, item 3)", file=sys.stderr)
        return 2

    from repro_torch.api.runtime import MeshFailure, PeMesh, mesh_devices
    from repro_torch.kernels.dispatch import resolve_device

    P = args.devices
    try:
        dev = resolve_device(args.device)
        devices = mesh_devices(P, dev if dev.type == "cpu" else None)
    except (RuntimeError, ValueError) as exc:
        print(f"selftest: {exc}; pass --device cpu for CPU ranks",
              file=sys.stderr)
        return 2
    ok = True

    def report(name, passed, **kw):
        nonlocal ok
        ok &= bool(passed)
        print(json.dumps({"test": name, "pass": bool(passed), **kw},
                         default=_plain), flush=True)

    def want(*names) -> bool:
        return bool(tests & set(names))

    meshes = {}

    def mesh_of(size):
        if size not in meshes:
            meshes[size] = PeMesh(devices[:size])
        return meshes[size]

    try:
        _checks(args, P, dev, want, report, mesh_of)
    except MeshFailure as exc:
        report("mesh", False, error=str(exc).splitlines()[0])
    finally:
        for m in meshes.values():
            m.close()
    return 0 if ok else 1


def _checks(args, P, dev, want, report, mesh_of):
    from repro_torch.core import metrics
    from repro_torch.core.deep_mgp import partition
    from repro_torch.graphs.distribute import distribute_graph

    cfg = _cfg()
    gkey = (args.family, args.n, 5)
    g = _graph(*gkey)
    k = args.k

    if want("all", "collectives", "smoke"):
        rng = np.random.default_rng(0)
        slab = rng.integers(0, 1000, size=(P, P, 3)).astype(np.int32)
        out = mesh_of(P).call(_rank_collectives, slab).value
        # ground truth: out[p, q] == in[q, p]
        truth = np.swapaxes(slab, 0, 1)
        report("collectives.direct", np.array_equal(out["direct"], truth))
        report("collectives.grid", np.array_equal(out["grid"], truth))

    if want("all", "halo", "smoke"):
        shards = distribute_graph(g, P)
        n, n_ghost = g.n, shards.n_ghost
        # per-vertex payload: an injective hash of the global id, so a
        # wrong routing cannot collide into a false pass

        def f_gid(x):
            return ((x.astype(np.int64) * 40503 + 7) % 65521) \
                .astype(np.int32)

        vals = np.where(shards.local_gid < n, f_gid(shards.local_gid), 0)
        out = mesh_of(P).call(_rank_halo, gkey, vals).value
        got_d, got_g = out["direct"], out["grid"]
        valid = shards.ghost_gid < n
        want_ghost = f_gid(np.where(valid, shards.ghost_gid, 0))
        ok_d = np.array_equal(got_d[valid], want_ghost[valid])
        ok_g = np.array_equal(got_g[valid], want_ghost[valid])
        report("halo.direct", ok_d, ghosts=int(valid.sum()),
               payload_bytes=shards.comm_bytes_per_halo(),
               n_ghost=n_ghost)
        report("halo.grid_vs_direct", ok_g and
               np.array_equal(got_d, got_g))

    if want("all", "cluster"):
        from repro_torch.core.coarsening import enforce_cluster_weights
        W = max(1, int(0.03 * g.total_vweight / k))
        raw, labels2, labels3 = mesh_of(P).call(_rank_cluster, gkey, W).value
        # driver behaviour: distributed revert is approximate (paper §4 —
        # races bounce weight back); exact enforcement happens before
        # contraction
        labels = enforce_cluster_weights(raw.copy(), np.asarray(g.vweights),
                                         W)
        cw = np.zeros(g.n + 1, dtype=np.int64)
        np.add.at(cw, labels, g.vweights)
        members = np.bincount(labels, minlength=g.n + 1)
        shrunk = np.unique(labels).size < 0.7 * g.n
        multi_ok = np.all(cw[members > 1] <= W)
        report("cluster.dist", shrunk and multi_ok,
               clusters=int(np.unique(labels).size), n=g.n, W=W,
               max_multi_cw=int(cw[members > 1].max() if
                                (members > 1).any() else 0))
        report("cluster.grid_vs_direct", np.array_equal(raw, labels2))
        # owner-sharded weight tables apply the same integer arithmetic in
        # the same order as the replicated all-reduce path -> identical
        report("cluster.owner_vs_replicated", np.array_equal(raw, labels3))

    if want("all", "contract"):
        from repro_torch.core.contraction import contract
        W = max(1, int(0.03 * g.total_vweight / k))
        labels, gc_d, map_d, stats, gc_2, map_2 = \
            mesh_of(P).call(_rank_contract, gkey, W).value
        gc_h, map_h = contract(g, labels, device=dev)
        # invariants: weight conservation, no self loops, symmetry
        src = gc_d.arc_tails()
        inv_ok = (gc_d.total_vweight == g.total_vweight
                  and bool(np.all(src != gc_d.adjncy)))
        try:
            gc_d.validate()
        except AssertionError:
            inv_ok = False
        # host and sharded contraction agree up to a coarse-id bijection
        pairs = np.unique(np.stack([map_h, map_d], 1), axis=0)
        iso_ok = (gc_d.n == gc_h.n and gc_d.m == gc_h.m
                  and pairs.shape[0] == gc_h.n
                  and np.unique(pairs[:, 0]).size == gc_h.n
                  and np.unique(pairs[:, 1]).size == gc_h.n)
        # cut of any coarse partition == cut of its fine projection
        rng = np.random.default_rng(4)
        pc = rng.integers(0, k, size=gc_d.n)
        cut_ok = metrics.edge_cut(gc_d, pc) == \
            metrics.edge_cut(g, pc[map_d])
        report("contract.sharded", inv_ok and iso_ok and cut_ok,
               coarse_m=gc_d.m, **stats)
        # grid and direct routing ship identical coarse graphs
        report("contract.grid_vs_direct",
               np.array_equal(map_2, map_d) and
               np.array_equal(gc_2.indptr, gc_d.indptr) and
               np.array_equal(gc_2.adjncy, gc_d.adjncy) and
               np.array_equal(gc_2.eweights, gc_d.eweights))

    lmax = np.full(k, metrics.l_max(g.total_vweight, k, 0.03,
                                    int(g.vweights.max())), dtype=np.int64)

    if want("all", "refine"):
        rng = np.random.default_rng(2)
        part0 = rng.integers(0, k, size=g.n)
        cut0 = metrics.edge_cut(g, part0)
        part1, part_u, u_rep, u_own = mesh_of(P).call(
            _rank_refine, gkey, part0, lmax).value
        cut1 = metrics.edge_cut(g, part1)
        feas = metrics.is_feasible(g, part1, k, 0.03)
        report("refine.dist", feas and cut1 < cut0, cut_before=cut0,
               cut_after=cut1, feasible=feas)
        # unconstrained tier: penalty-weighted moves + afterburner repair
        # must end feasible and improve the same random start
        cut_u = metrics.edge_cut(g, part_u)
        feas_u = metrics.is_feasible(g, part_u, k, 0.03)
        report("refine.unconstrained", feas_u and cut_u < cut0,
               cut_before=cut0, cut_after=cut_u, cut_lp=cut1,
               feasible=feas_u)
        # owner-sharded and replicated weight tables are bit-identical
        # for the unconstrained pass (same dense table at every chunk top)
        report("refine.unconstrained.owner_vs_replicated",
               np.array_equal(u_rep, u_own))

    if want("all", "balance"):
        from repro_torch.core.balance import rebalance
        from repro_torch.core.coarsening import (ejection_candidates,
                                                 enforce_cluster_weights)
        part0 = np.zeros(g.n, dtype=np.int64)   # adversarial: one block

        # distributed balancer == host balancer, bit for bit, at P=1
        want_p1 = rebalance(g, part0.copy(), lmax, seed=11, device=dev)
        got_p1 = mesh_of(1).call(_rank_rebalance_p1, gkey, part0,
                                 lmax).value
        report("balance.p1_bit_identical", np.array_equal(want_p1, got_p1))

        rng = np.random.default_rng(7)
        labels = rng.integers(0, max(2, k), g.n).astype(np.int64)
        W = max(1, int(g.total_vweight / (4 * k)))
        out = mesh_of(P).call(_rank_balance, gkey, k, part0, lmax, labels,
                              W, cfg).value
        # P devices: feasibility from the adversarial start, identical
        # labels across routing and weight-table layouts
        bw = np.zeros(k, dtype=np.int64)
        np.add.at(bw, out["fixed"], g.vweights)
        report("balance.dist_adversarial", bool(np.all(bw <= lmax)),
               rounds=out["stats"]["rounds"],
               pool_bytes=out["stats"]["pool_bytes"])
        report("balance.grid_owner_equal",
               np.array_equal(out["fixed"], out["fixed_d"]) and
               np.array_equal(out["fixed"], out["fixed_o"]))
        # heterogeneous per-block budgets stay exactly enforced
        bwh = np.zeros(k, dtype=np.int64)
        np.add.at(bwh, out["fixed_h"], g.vweights)
        report("balance.heterogeneous_lmax",
               bool(np.all(bwh <= out["lvec"])))
        # sharded cluster-weight enforcement ejects the same vertex set
        # as the host sweep and yields the same clustering up to a
        # relabeling of the fresh singletons
        lab_d = out["lab_d"]
        ej = ejection_candidates(labels, np.asarray(g.vweights), W)
        same_set = np.array_equal(np.sort(np.flatnonzero(lab_d != labels)),
                                  np.sort(ej))

        def canon(lab):
            _, inv = np.unique(lab, return_inverse=True)
            first = np.full(int(inv.max()) + 1, g.n, dtype=np.int64)
            np.minimum.at(first, inv, np.arange(g.n))
            return first[inv]

        lab_h = enforce_cluster_weights(labels.copy(),
                                        np.asarray(g.vweights), W)
        report("balance.enforce_sharded", same_set and
               np.array_equal(canon(lab_d), canon(lab_h)),
               ejected=int(ej.size))
        # full uncoarsening path with balance="dist": no host-side
        # rebalance gather, feasible, within the 1.5x quality bound
        ref_cut = metrics.edge_cut(g, partition(g, k, cfg, device=dev))
        for wmode in ("replicated", "owner"):
            s_b, seeds, calls = out[wmode]
            levels = len(seeds)
            report(f"balance.no_host_gather_{wmode}",
                   s_b["feasible"] and calls == 0 and
                   levels >= 1 and len(set(seeds)) == levels and
                   s_b["cut"] <= max(1.5 * ref_cut, ref_cut + 50),
                   cut=s_b["cut"], ref_cut=ref_cut, levels=levels,
                   host_rebalance_calls=calls)
        # instrumentation sanity: the host mode *does* hit the counter
        report("balance.host_gather_counter_sane", out["host_calls"] >= 1,
               host_rebalance_calls=out["host_calls"])

    if want("all", "partition"):
        part, part_sh = mesh_of(P).call(_rank_partition, gkey, k, cfg).value
        s = metrics.summarize(g, part, k, 0.03)
        cut_ref = metrics.edge_cut(g, partition(g, k, cfg, device=dev))
        # distributed quality within 1.5x of the single-process partition
        report("partition.dist", s["feasible"] and
               s["cut"] <= max(1.5 * cut_ref, cut_ref + 50),
               dist=s, ref_cut=cut_ref)
        # fully sharded memory model: in-place contraction + owner-sharded
        # weight tables must stay feasible within the same quality bound
        s_sh = metrics.summarize(g, part_sh, k, 0.03)
        report("partition.dist_sharded_owner", s_sh["feasible"] and
               s_sh["cut"] <= max(1.5 * cut_ref, cut_ref + 50),
               dist=s_sh, ref_cut=cut_ref)

    if want("all", "api"):
        from repro_torch.api import PartitionRequest, PartitionSession
        mesh = mesh_of(P)
        assign, feasible, cut, levels, driver, auto = mesh.call(
            _rank_api, gkey, k, cfg).value
        # facade(dist-grid) must reproduce the direct driver bit-exactly
        report("api.dist_matches_driver",
               feasible and np.array_equal(assign, driver),
               cut=cut, levels=levels)
        # feasibility flag must agree with the metrics module
        report("api.feasible_flag",
               feasible == metrics.is_feasible(g, assign, k, 0.03))
        # auto policy routes this (large-enough) graph to a dist backend;
        # at P = 1 the policy keeps every request single-process
        report("api.auto_backend",
               auto in (("dist", "dist-grid") if P > 1 else ("single",)),
               backend=auto)
        # batched session over the mesh == per-request solo runs
        reqs = [PartitionRequest(graph=g, k=kk, config=cfg, backend="dist",
                                 devices=P)
                for kk in (k, max(1, k // 2))]
        with PartitionSession(devices=P, max_workers=2, mesh=mesh,
                              device=dev) as sess:
            batch = sess.run_batch(reqs)
            served = sess.stats()["served"]
        solo = [mesh.call(_rank_solo, r).value for r in reqs]
        same = all(np.array_equal(b.assignment, s)
                   for b, s in zip(batch, solo))
        report("api.session_batch", same and served == len(reqs),
               served=served, cuts=[b.cut for b in batch])

    if want("all", "serve"):
        _serve_checks(args, P, dev, cfg, report)

    if want("all", "batch"):
        _batch_checks(args, dev, cfg, report)

    if want("kernels"):
        # fused hot loops (the CUDA kernels on the card, their plain
        # versions on the CPU) vs the composed torch ops: labels AND cut
        # bit-identical — host path and both distributed memory models,
        # on a reduced instance
        from repro_torch.core.deep_mgp import PartitionerConfig
        nn = max(400, args.n // 4)
        gk = _graph(args.family, nn, 13)
        kk = max(2, k // 2)
        cfg_k = PartitionerConfig(contraction_limit=80, ip_repetitions=1,
                                  num_chunks=4, seed=3)
        parts = {mode: partition(gk, kk, dataclasses.replace(
            cfg_k, kernel=mode), device=dev)
            for mode in ("composed", "fused")}
        cut_f = metrics.edge_cut(gk, parts["fused"])
        report("kernels.host_bit_identical",
               np.array_equal(parts["fused"], parts["composed"]) and
               cut_f == metrics.edge_cut(gk, parts["composed"]),
               cut=cut_f, n=gk.n)
        mesh = mesh_of(P)
        mesh.reset_counts()
        got = mesh.call(_rank_kernels, (args.family, nn, 13), kk,
                        cfg_k).value
        for name in ("host_replicated", "sharded_owner"):
            fused = got[name, "fused"]
            feas = metrics.is_feasible(gk, fused, kk, 0.03)
            report(f"kernels.dist_bit_identical_{name}",
                   np.array_equal(fused, got[name, "composed"]) and feas,
                   cut=metrics.edge_cut(gk, fused), P=P, feasible=feas)
        if dev.type == "cuda":
            # on the card the fused runs must have gone through the
            # kernels' distributed forms
            launched = mesh.launches[0]
            report("kernels.dist_launched",
                   launched.get("lp_move_dist", 0) > 0 and
                   launched.get("greedy_pick", 0) > 0,
                   launches={k_: v for k_, v in launched.items() if v})

    if want("fabric"):
        _fabric_checks(args, dev, cfg, report)


def _serve_checks(args, P, dev, cfg, report):
    import time

    from repro_torch.api import GraphSpec, PartitionRequest
    from repro_torch.serve import PartitionServer

    dpm = max(1, P // 2)
    # >= 8 concurrent mixed-size requests: three sizes, two k values,
    # and (with two devices a mesh or more) distributed requests that
    # exercise the second mesh's device slice
    mixed = []
    for i in range(8):
        nn = max(600, args.n // 4) * (1 + i % 3)
        kk = max(2, args.k // 2) * (1 + i % 2)
        d = dpm if (i % 4 == 3 and dpm > 1) else 1
        mixed.append(PartitionRequest(
            graph=GraphSpec(args.family, nn, 8.0, seed=23 + i % 3),
            k=kk, config=cfg, devices=d))
    solo = _solo_runs(mixed, dev)

    # 2-mesh server over disjoint device slices drains the batch
    # bit-identically to solo runs, using both meshes
    with PartitionServer(meshes=2, devices_per_mesh=dpm, device=dev) as srv:
        results = srv.serve(mixed)
        st = srv.stats()
    same = all(r.ok and np.array_equal(r.result.assignment, s.assignment)
               for r, s in zip(results, solo))
    report("serve.bit_identical_mixed",
           same and st["completed"] == len(mixed),
           served=st["per_worker_served"],
           queue_depth_max=st["queue_depth_max"])
    report("serve.both_meshes_used",
           all(c > 0 for c in st["per_worker_served"]),
           served=st["per_worker_served"])

    # a killed worker's requests complete via retry on the other mesh —
    # hold worker 1 at its gate so it provably owns work
    with PartitionServer(meshes=2, devices_per_mesh=dpm, device=dev) as srv:
        srv.workers[1].hold()
        futs = [srv.submit(r) for r in mixed[:4]]
        t_end = time.monotonic() + 30
        while time.monotonic() < t_end and srv.workers[1].inflight == 0:
            time.sleep(0.01)
        had_work = srv.workers[1].inflight > 0
        srv.kill_worker(1)
        rs = [f.result(timeout=600) for f in futs]
        st = srv.stats()
    same_k = all(r.ok and np.array_equal(r.result.assignment, s.assignment)
                 for r, s in zip(rs, solo[:4]))
    report("serve.killed_worker_retry",
           had_work and same_k and st["retried"] >= 1 and
           st["per_worker_served"][1] == 0,
           retried=st["retried"], served=st["per_worker_served"])

    # deadline expiry surfaces a structured error, not a hang
    with PartitionServer(meshes=2, devices_per_mesh=1, device=dev) as srv:
        for w in srv.workers:
            w.hold()
        fut = srv.submit(mixed[0], deadline_s=0.05)
        time.sleep(0.2)
        for w in srv.workers:
            w.release()
        r = fut.result(timeout=60)
        st = srv.stats()
    report("serve.deadline_error",
           (not r.ok) and r.error == "deadline_exceeded" and
           st["expired"] == 1, error=r.error)


def _batch_checks(args, dev, cfg, report):
    import time

    from repro_torch.api import (GraphSpec, PartitionRequest, Partitioner,
                                 PartitionSession)
    from repro_torch.serve import PartitionServer, run_coalesced

    engine = Partitioner(device=dev)
    nn = max(400, args.n // 4)
    distinct = [PartitionRequest(
        graph=GraphSpec(args.family, nn, 8.0, seed=31 + i),
        k=max(2, args.k // 2), config=cfg, backend="single")
        for i in range(4)]
    solo = [engine.run(r) for r in distinct]

    # a duplicate-heavy hot mix piles up behind a held worker, then
    # drains as batches: bit-identical results, coalescing observed
    mix = [distinct[i % 4] for i in range(12)]
    with PartitionServer(meshes=1, batch_max=8, batch_window_ms=50.0,
                         device=dev) as srv:
        srv.workers[0].hold()
        futs = [srv.submit(r) for r in mix]
        t_end = time.monotonic() + 30
        while time.monotonic() < t_end and srv.workers[0].inflight == 0:
            time.sleep(0.01)
        srv.workers[0].release()
        rs = [f.result(timeout=600) for f in futs]
        st = srv.stats()
    same = all(r.ok and np.array_equal(r.result.assignment,
                                       solo[i % 4].assignment)
               for i, r in enumerate(rs))
    report("batch.coalesced_bit_identical",
           same and st["completed"] == len(mix) and
           st["batches"] >= 1 and st["coalesced"] >= 1,
           batches=st["batches"], coalesced=st["coalesced"],
           batch_size_max=st["batch_size_max"])

    # the stacked level-0 path, forced on (the CPU auto-gate would skip
    # it), reproduces solo results bit for bit
    with PartitionSession(devices=1, stack="on", device=dev) as sess:
        out = run_coalesced(sess, distinct, stack="on")
    report("batch.stacked_bit_identical",
           all(np.array_equal(o.assignment, s.assignment) and o.cut == s.cut
               for o, s in zip(out, solo)),
           cuts=[o.cut for o in out])


def _fabric_checks(args, dev, cfg, report):
    # spawns real worker subprocesses (each imports torch and takes its
    # own CUDA context), so it is not part of "all"
    import signal as _signal
    import subprocess
    import time

    import repro_torch
    from repro_torch.api import GraphSpec, PartitionRequest, Partitioner
    from repro_torch.fabric import FabricClient, status_of

    src_dir = os.path.dirname(os.path.dirname(repro_torch.__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    device_args = ["--device", str(dev)] if dev.type == "cpu" else []

    def spawn(role, *extra):
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fabric", role,
             *extra], stdout=subprocess.PIPE, env=env, text=True)
        ready = json.loads(proc.stdout.readline())
        return proc, ready

    fd_proc, fd_ready = spawn("frontdoor", "--lease-ttl-s", "3.0")
    host, port = fd_ready["host"], fd_ready["port"]
    w_procs = {}
    try:
        for i in range(2):
            proc, _ = spawn("worker", "--frontdoor", f"{host}:{port}",
                            "--server-id", f"selftest-w{i}",
                            "--heartbeat-s", "0.3", *device_args)
            w_procs[f"selftest-w{i}"] = proc
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end and \
                len(status_of(host, port)["servers"]) < 2:
            time.sleep(0.1)
        regs = [s["server_id"] for s in status_of(host, port)["servers"]]
        report("fabric.registered", sorted(regs) ==
               ["selftest-w0", "selftest-w1"], servers=regs)

        engine = Partitioner(device=dev)
        nn = max(600, args.n // 4)
        mixed = [PartitionRequest(
            graph=GraphSpec(args.family, nn * (1 + i % 2), 8.0,
                            seed=41 + i % 3),
            k=max(2, args.k // 2) * (1 + i % 2), config=cfg)
            for i in range(6)]
        solo = [engine.run(r) for r in mixed]
        with FabricClient(host, port) as client:
            rs = client.serve(mixed)
            same = all(r.ok and np.array_equal(r.assignment, s.assignment)
                       for r, s in zip(rs, solo))
            report("fabric.bit_identical_2proc",
                   same and {r.server for r in rs} == set(w_procs),
                   servers=sorted({str(r.server) for r in rs}))

            # SIGKILL one worker while it provably owns a request: every
            # admitted ticket must still resolve ok via failover to the
            # survivor — none may hang
            slow = [PartitionRequest(
                graph=GraphSpec(args.family, max(2000, args.n // 2), 8.0,
                                seed=51 + i % 2),
                k=args.k, config=cfg) for i in range(6)]
            slow_solo = [engine.run(r) for r in slow]
            futs = [client.submit(r) for r in slow]
            victim = None
            t_end = time.monotonic() + 60
            while victim is None and time.monotonic() < t_end:
                for s in status_of(host, port)["servers"]:
                    if s.get("inflight", 0) > 0:
                        victim = s["server_id"]
                        break
                time.sleep(0.02)
            report("fabric.victim_had_work", victim is not None,
                   victim=victim)
            w_procs[victim].send_signal(_signal.SIGKILL)
            rs = [f.result(timeout=600) for f in futs]
            survivor = next(s for s in w_procs if s != victim)
            same = all(r.ok and np.array_equal(r.assignment, s.assignment)
                       for r, s in zip(rs, slow_solo))
            retried = sum(1 for r in rs if r.attempts > 1)
            report("fabric.sigkill_failover",
                   same and retried >= 1 and
                   all(r.server == survivor for r in rs),
                   retried=retried, attempts=[r.attempts for r in rs])

            # SIGTERM drain of the survivor: the in-flight request
            # finishes ok, queued ones resolve with a structured error
            # (deadline at the latest) — nothing hangs. Let the survivor
            # heartbeat an idle window first, so worker_inflight below
            # comes from these submissions
            time.sleep(0.8)
            futs = [client.submit(r, deadline_s=20.0) for r in slow[:4]]
            t_end = time.monotonic() + 60
            while time.monotonic() < t_end and not any(
                    s.get("worker_inflight", 0) > 0
                    for s in status_of(host, port)["servers"]):
                time.sleep(0.02)
            w_procs[survivor].send_signal(_signal.SIGTERM)
            rs = [f.result(timeout=600) for f in futs]
            w_procs[survivor].wait(timeout=120)
            n_ok = sum(1 for r in rs if r.ok)
            structured = all(
                r.ok or r.error in ("server_closed", "worker_failed",
                                    "no_worker", "deadline_exceeded")
                for r in rs)
            report("fabric.sigterm_drain", n_ok >= 1 and structured,
                   ok=n_ok, errors=[r.error for r in rs if not r.ok])
    finally:
        for proc in w_procs.values():
            if proc.poll() is None:
                proc.kill()
        fd_proc.send_signal(_signal.SIGTERM)
        try:
            fd_proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fd_proc.kill()


if __name__ == "__main__":
    sys.exit(main())
