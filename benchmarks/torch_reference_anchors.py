#!/usr/bin/env python3
"""The JAX reference's answers to the port's full-size requests, and the
port's answers to the same requests beside them.

    JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python3 benchmarks/torch_reference_anchors.py \\
        [--n 1048576] [--side ref|port|both] [--dist | --placement]
        [--out FILE]

The request is ``chip_smoke.py``'s slice at full size: rgg2d (seed 17),
k=16, eps=0.03, preset ``fast``, ``refine="unconstrained"``, backend
``single``, then ``Partitioner.compare`` of the same request against
``plain_mgp`` and ``single_level_lp``. ``--side ref`` runs the JAX
package on the CPU with ``kernel="composed"`` (its fused balancer needs
Pallas features newer JAX lacks); ``--side port`` runs ``repro_torch`` on
the CUDA device with ``kernel="fused"``; ``both`` runs the two and fails
unless their assignments, cuts and traces (wall times apart) agree. It
prints one JSON object per side: each run's cut, feasibility, wall
seconds and trace (``refine-mode`` records included), the constants that
``chip_smoke.py`` holds the port to; ``--out`` also writes them there.

``--dist`` asks instead for the distributed engine at P=1 (backend
``dist``, ``devices=1``, preset ``fast``) in both memory models: the
default (host contraction, host balance, replicated tables) and
``contraction="sharded"``, ``balance="dist"``, ``weights="owner"``. Each
run also gives the sha256 of its int64 assignment. The reference's
``dist`` modules need the test suite's ``shard_map`` shim on this jax
(``tests/torch_dist_jobs.py::install_reference_shim``); the port runs in
a one-rank NCCL group on the card.

``--placement`` asks instead for the GNN placement that ``chip_smoke.py``
phase 12a runs: rgg2d (seed 17) with its ids shuffled by
``np.random.default_rng(0).permutation`` (as ``tests/test_placement.py``
shuffles them), placed on 8 devices by ``gnn_placement.plan`` with
``fast_config(seed=0)``. Each side gives the cut, the sha256 of the
int64 block of every input vertex (read off ``perm`` and ``offsets``),
the offsets and the halo bytes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BASELINES = ("plain_mgp", "single_level_lp")
DIST_MODELS = {"default": {},
               "sharded": {"contraction": "sharded", "balance": "dist",
                           "weights": "owner"}}


def digest(assignment) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        assignment, dtype=np.int64).tobytes()).hexdigest()


def strip(trace):
    return [{k: v for k, v in rec.items() if k != "time_s"}
            for rec in trace]


def run_side(api, graph, kernel, device=None):
    """One unconstrained run and the comparison, on one package."""
    kw = {} if device is None else {"device": device}
    engine = api.Partitioner(**kw)
    req = api.PartitionRequest(graph=graph, k=16, epsilon=0.03,
                               preset="fast", backend="single",
                               kernel=kernel, refine="unconstrained")
    t0 = time.perf_counter()
    res = engine.run(req)
    wall = time.perf_counter() - t0
    out = {"unconstrained": {"cut": res.cut, "feasible": res.feasible,
                             "wall_s": wall, "trace": list(res.trace)}}
    assignments = {"unconstrained": res.assignment}
    for name, r in zip(BASELINES, engine.compare(req, BASELINES)):
        out[name] = {"cut": r.cut, "feasible": r.feasible,
                     "wall_s": r.time_s}
        assignments[name] = r.assignment
    return out, assignments


def run_dist(api, graph, kernel, device=None):
    """The distributed engine at P=1 in both memory models."""
    kw = {} if device is None else {"device": device}
    engine = api.Partitioner(**kw)
    out, assignments = {}, {}
    for name, model in DIST_MODELS.items():
        req = api.PartitionRequest(graph=graph, k=16, epsilon=0.03,
                                   preset="fast", backend="dist", devices=1,
                                   kernel=kernel, **model)
        t0 = time.perf_counter()
        res = engine.run(req)
        out[name] = {"cut": res.cut, "feasible": res.feasible,
                     "wall_s": time.perf_counter() - t0,
                     "sha256": digest(res.assignment),
                     "trace": list(res.trace)}
        assignments[name] = res.assignment
    return out, assignments


def run_placement(placement, partitioner, permute, graph, kernel,
                  device=None):
    """The GNN placement of ``graph``, ids shuffled, on 8 devices."""
    g, _ = permute(graph, np.random.default_rng(0).permutation(graph.n))
    kw = {} if device is None else {"device": device}
    t0 = time.perf_counter()
    plan = placement.plan(g, 8, partitioner.fast_config(seed=0,
                                                        kernel=kernel), **kw)
    blocks = np.searchsorted(plan.offsets, plan.perm, side="right") - 1
    out = {"cut": int(plan.cut), "sha256": digest(blocks),
           "wall_s": time.perf_counter() - t0,
           "offsets": [int(x) for x in plan.offsets],
           "halo_bytes": int(plan.halo_bytes),
           "baseline_halo_bytes": int(plan.baseline_halo_bytes)}
    return {"placement": out}, {"placement": blocks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--side", default="both", choices=["ref", "port", "both"])
    ap.add_argument("--dist", action="store_true",
                    help="the distributed engine at P=1, both memory models")
    ap.add_argument("--placement", action="store_true",
                    help="the GNN placement of chip_smoke.py phase 12a")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    run = run_dist if args.dist else run_side
    result = {"n": args.n, "dist": args.dist, "placement": args.placement}
    runs = {}
    if args.side in ("ref", "both"):
        if args.dist:
            sys.path.insert(0, str(ROOT / "tests"))
            from torch_dist_jobs import install_reference_shim
            install_reference_shim(devices=1)
        from repro import api as ref_api
        from repro.graphs import generators as ref_generators

        g = ref_generators.make("rgg2d", args.n, 8.0, seed=17)
        if args.placement:
            from repro.core import partitioner as ref_partitioner
            from repro.graphs.format import permute as ref_permute
            from repro.placement import gnn_placement as ref_placement
            result["ref"], runs["ref"] = run_placement(
                ref_placement, ref_partitioner, ref_permute, g, "composed")
        else:
            result["ref"], runs["ref"] = run(ref_api, g, "composed")
        print(json.dumps({"ref": result["ref"]}), flush=True)
    if args.side in ("port", "both"):
        import torch

        from repro_torch import api

        if not torch.cuda.is_available():
            print("torch_reference_anchors: no CUDA device", file=sys.stderr)
            return 2
        g = api.GraphSpec("rgg2d", args.n, 8.0, seed=17).materialize()
        if args.placement:
            from repro_torch.core import partitioner
            from repro_torch.graphs.format import permute
            from repro_torch.placement import gnn_placement
            result["port"], runs["port"] = run_placement(
                gnn_placement, partitioner, permute, g, "fused",
                device="cuda")
        else:
            result["port"], runs["port"] = run(api, g, "fused",
                                               device="cuda")
        result["device"] = torch.cuda.get_device_name(0)
        print(json.dumps({"port": result["port"],
                          "device": result["device"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    if len(runs) == 2:
        bad = [name for name in runs["ref"]
               if not np.array_equal(runs["ref"][name], runs["port"][name])]
        for name, ref_r in result["ref"].items():
            if "trace" in ref_r and strip(ref_r["trace"]) != \
                    strip(result["port"][name]["trace"]):
                bad.append(f"{name} trace")
            for key in ("cut", "offsets", "halo_bytes",
                        "baseline_halo_bytes"):
                if key in ref_r and ref_r[key] != result["port"][name][key]:
                    bad.append(f"{name} {key}")
        print(json.dumps({"agree": not bad, "differ": bad}))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
