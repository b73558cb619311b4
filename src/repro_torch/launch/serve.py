"""Serving-tier CLI of the port — drive a ``PartitionServer`` (the JAX
package's ``launch/serve.py`` flag for flag, plus ``--device``).

  python -m repro_torch.launch.serve --meshes 2 --requests 12 --n 4000 \\
      --k 8 --verify
  python -m repro_torch.launch.serve ... --offered-rate 8   # paced
  python -m repro_torch.launch.serve ... --device cpu

Generates a mixed request set (three sizes, two k values), serves it
through the admission queue on the CUDA device unless ``--device`` names
another, prints one JSON summary line per result and a final stats
line. ``--verify`` re-runs every request solo through
``repro_torch.api.Partitioner`` on the same device and asserts
bit-identical assignments. Exit 0 iff every request succeeded (and
verified). ``--devices-per-mesh`` above 1 needs the distributed engine,
which is not ported (exit 2).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_requests(args):
    """A deterministic mixed workload: three sizes, two k values, five
    graph seeds (the reference CLI's, single-device)."""
    from repro_torch.api import GraphSpec, PartitionRequest
    from repro_torch.core.deep_mgp import PartitionerConfig

    cfg = PartitionerConfig(
        contraction_limit=128, ip_repetitions=2, num_chunks=4)
    reqs = []
    for i in range(args.requests):
        n = args.n // 2 * (1 + i % 3)           # n/2, n, 3n/2
        k = args.k * (1 + i % 2)                # k, 2k
        reqs.append(PartitionRequest(
            graph=GraphSpec(args.family, n, 8.0, seed=11 + i % 5),
            k=k, config=cfg, collect_trace=False))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", type=int, default=2)
    ap.add_argument("--devices-per-mesh", type=int, default=1)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--family", default="rgg2d")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--offered-rate", type=float, default=0.0,
                    help="requests/s admission pacing (0 = burst)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request completion deadline")
    ap.add_argument("--verify", action="store_true",
                    help="assert bit-identity against solo runs")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "device; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    from repro_torch.kernels.dispatch import NoCudaDevice
    from repro_torch.serve import PartitionServer

    reqs = build_requests(args)
    t0 = time.perf_counter()
    try:
        srv = PartitionServer(meshes=args.meshes,
                              devices_per_mesh=args.devices_per_mesh,
                              device=args.device)
    except NotImplementedError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    except NoCudaDevice as exc:
        print(f"serve: no CUDA device ({exc}); pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    with srv:
        futures = []
        for i, r in enumerate(reqs):
            futures.append(srv.submit(r, priority=i % 2,
                                      deadline_s=args.deadline_s))
            if args.offered_rate > 0:
                time.sleep(1.0 / args.offered_rate)
        results = [f.result() for f in futures]
        stats = srv.stats()
    wall = time.perf_counter() - t0

    ok = all(r.ok for r in results)
    for r in results:
        print(json.dumps(r.summary()), flush=True)

    if args.verify:
        import numpy as np

        from repro_torch.api import Partitioner
        engine = Partitioner(device=args.device)
        for r, req in zip(results, reqs):
            if not r.ok:
                continue
            solo = engine.run(req)
            if not np.array_equal(r.result.assignment, solo.assignment):
                print(json.dumps({"verify": "MISMATCH",
                                  "k": req.k, "n": req.graph.n}))
                ok = False
        print(json.dumps({"verify": "bit-identical" if ok else "failed"}))

    stats["wall_s"] = round(wall, 3)
    stats["throughput_rps"] = round(len(results) / max(wall, 1e-9), 3)
    print(json.dumps({"stats": stats}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
