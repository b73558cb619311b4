#!/usr/bin/env python3
"""The JAX reference's answers to the port's full-size requests, and the
port's answers to the same requests beside them.

    JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python3 benchmarks/torch_reference_anchors.py \\
        [--n 1048576] [--side ref|port|both] [--out FILE]

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
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BASELINES = ("plain_mgp", "single_level_lp")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--side", default="both", choices=["ref", "port", "both"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    result = {"n": args.n}
    runs = {}
    if args.side in ("ref", "both"):
        from repro import api as ref_api
        from repro.graphs import generators as ref_generators

        g = ref_generators.make("rgg2d", args.n, 8.0, seed=17)
        result["ref"], runs["ref"] = run_side(ref_api, g, "composed")
        print(json.dumps({"ref": result["ref"]}), flush=True)
    if args.side in ("port", "both"):
        import torch

        from repro_torch import api

        if not torch.cuda.is_available():
            print("torch_reference_anchors: no CUDA device", file=sys.stderr)
            return 2
        g = api.GraphSpec("rgg2d", args.n, 8.0, seed=17).materialize()
        result["port"], runs["port"] = run_side(api, g, "fused",
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
        ref_u, port_u = result["ref"]["unconstrained"], \
            result["port"]["unconstrained"]
        if strip(ref_u["trace"]) != strip(port_u["trace"]):
            bad.append("unconstrained trace")
        print(json.dumps({"agree": not bad, "differ": bad}))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
