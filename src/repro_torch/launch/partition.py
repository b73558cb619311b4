"""Partitioner CLI of the port, on the ``repro_torch.api`` facade — the
reference's ``repro.launch.partition`` flag for flag, plus ``--device``.

  python -m repro_torch.launch.partition --family rgg2d --n 20000 --k 16
  python -m repro_torch.launch.partition --family rhg --n 10000 --k 64 \\
      --preset strong --compare
  python -m repro_torch.launch.partition ... --quality best --trace
  python -m repro_torch.launch.partition ... --device cpu

Runs on the CUDA device unless ``--device`` names another (``cpu`` on
purpose). Prints one JSON summary line per backend run; exit 0 iff the
primary run is feasible.
"""
from __future__ import annotations

import argparse
import json
import sys

COMPARE_BACKENDS = ["plain_mgp", "single_level_lp"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="rgg2d")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--epsilon", type=float, default=0.03)
    ap.add_argument("--preset", default="fast", choices=["fast", "strong"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    help="registry name (single | plain_mgp | "
                         "single_level_lp) or 'auto'")
    ap.add_argument("--compare", action="store_true",
                    help="also run plain-MGP and single-level baselines "
                         "as backends of the same request")
    ap.add_argument("--devices", type=int, default=0,
                    help="PE count of the request; more than 1 resolves "
                         "to a distributed backend, not ported yet")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA "
                         "device; 'cpu' on purpose)")
    ap.add_argument("--contraction", default=None,
                    choices=["host", "sharded"],
                    help="dist-backend memory model (ignored by the "
                         "single-device backends)")
    ap.add_argument("--weights", default=None,
                    choices=["replicated", "owner"],
                    help="dist-backend weight tables (ignored by the "
                         "single-device backends)")
    ap.add_argument("--balance", default=None,
                    choices=["host", "dist"],
                    help="dist-backend balancer (ignored by the "
                         "single-device backends)")
    ap.add_argument("--kernel", default=None,
                    choices=["auto", "fused", "composed"],
                    help="hot-loop implementation: the CUDA kernels "
                         "(fused) or torch ops (composed); bit-identical "
                         "results")
    ap.add_argument("--refine", default=None,
                    choices=["lp", "unconstrained"],
                    help="refinement algorithm: size-constrained LP "
                         "(default) or the Jet-style unconstrained search "
                         "with afterburner repair (always feasible)")
    ap.add_argument("--quality", default=None,
                    choices=["fast", "best"],
                    help="serving-facing spelling of --refine (fast=lp, "
                         "best=unconstrained); an explicit --refine wins")
    ap.add_argument("--trace", action="store_true",
                    help="also print the per-level trace records")
    args = ap.parse_args(argv)

    from repro_torch.api import GraphSpec, PartitionRequest, Partitioner

    req = PartitionRequest(
        graph=GraphSpec(args.family, args.n, args.avg_deg, seed=args.seed),
        k=args.k, epsilon=args.epsilon, preset=args.preset,
        seed=args.seed, backend=args.backend,
        devices=args.devices or 1,
        contraction=args.contraction, weights=args.weights,
        balance=args.balance, kernel=args.kernel, refine=args.refine,
        quality=args.quality)
    try:
        engine = Partitioner(device=args.device)
    except RuntimeError as exc:
        print(f"partition: no CUDA device ({exc}); pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2
    res = engine.run(req)
    print(json.dumps(res.summary()))
    if args.trace:
        for rec in res.trace:
            print(json.dumps(rec))
    if args.compare:
        for r in engine.compare(req, COMPARE_BACKENDS):
            print(json.dumps(r.summary()))
    return 0 if res.feasible else 1


if __name__ == "__main__":
    sys.exit(main())
