"""Partitioner CLI of the port, on the ``repro_torch.api`` facade — the
reference's ``repro.launch.partition`` flag for flag, plus ``--device``.

  python -m repro_torch.launch.partition --family rgg2d --n 20000 --k 16
  python -m repro_torch.launch.partition --family rhg --n 10000 --k 64 \\
      --preset strong --compare
  python -m repro_torch.launch.partition ... --quality best --trace
  python -m repro_torch.launch.partition ... --device cpu
  python -m repro_torch.launch.partition ... --devices 4   # distributed

Runs on the CUDA device unless ``--device`` names another (``cpu`` on
purpose). ``--devices P`` with P > 1 spawns P ranks, one process a PE
(a card each, or the CPU with ``--device cpu``), joined through
``api.runtime.distributed_init``; every rank runs the request and rank 0
prints. Prints one JSON summary line per backend run; exit 0 iff the
primary run is feasible.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
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
                    help="PE count of the request: more than 1 spawns one "
                         "rank a PE and resolves to a distributed backend")
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
    if args.devices > 1:
        return _spawn(args)
    return _run(args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args) -> int:
    """Run the request on ``args.devices`` ranks, one process each."""
    import multiprocessing as mp
    if args.device is None or not args.device.startswith("cpu"):
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < args.devices:
            print(f"partition: no CUDA device for each of {args.devices} "
                  f"ranks ({have} visible); pass --device cpu to run the "
                  "ranks on the CPU", file=sys.stderr)
            return 2
    addr = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(args, addr, r))
             for r in range(args.devices)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join()
    codes = [pr.exitcode for pr in procs]
    # 0 / 1: rank 0's feasible / infeasible; anything else: a rank failed
    return codes[0] if all(c in (0, 1) for c in codes) else 3


def _rank(args, addr: str, rank: int) -> None:
    os.environ.update(REPRO_COORDINATOR=addr,
                      REPRO_NUM_PROCESSES=str(args.devices),
                      REPRO_PROCESS_ID=str(rank))
    import torch
    import torch.distributed as dist
    if args.device is not None and args.device.startswith("cpu"):
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.devices))
    from repro_torch.api import runtime
    try:
        runtime.distributed_init(device=args.device)
        code = _run(args, quiet=rank != 0)
        dist.destroy_process_group()
    except Exception:
        import traceback
        traceback.print_exc()
        code = 3
    sys.exit(code)


def _run(args, quiet: bool = False) -> int:
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
    if quiet:       # another rank prints
        return 0 if res.feasible else 1
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
