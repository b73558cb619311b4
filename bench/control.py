"""The control of the benchmark's correctness check, and the faults it
must catch: each puts a broken stage in the program's place, and a run of
the cell must then come out not correct.

The control is the plain clustering put in the program's place with its
tie chain cut to the first key: among a vertex's best-connected labels it
takes the smallest, skipping the lighter cluster and the salted hash
(paper section 4). That is the step that would tempt a faster ``lp_move``
kernel (one reduction a row instead of four), and it breaks a guarantee
the configurations state, the exact answer.

On the card, at a cell's own size, for each seed:

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20

prints one JSON line a seed with the run's ``correct`` and compared
numbers. The benchmark's own runs never plant anything.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import sys
import time

import numpy as np


@contextlib.contextmanager
def planted(module: str, attr: str, make):
    """``module.attr`` replaced by ``make(original)`` inside the block."""
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, functools.wraps(orig)(make(orig)))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def control():
    """The plain clustering with ties broken by the label alone, in place
    of the program's."""
    from .reference import plain

    def make(orig):
        def cluster(g, max_cluster_weight, num_iterations=3, num_chunks=8,
                    seed=0, kernel="auto", device=None):
            return plain.cluster(g, max_cluster_weight, num_iterations,
                                 num_chunks, seed, device or "cuda",
                                 full_ties=False)
        return cluster
    return planted("repro_torch.core.deep_mgp", "cluster", make)


def fault_unchanged_step():
    """A step that returns its state unchanged: every clustering pass
    leaves the labels as they came, on the torch-op path and the kernel's."""
    def make(orig):
        def cluster_iteration(labels, cluster_w, *a, **kw):
            return labels, cluster_w
        return cluster_iteration

    stack = contextlib.ExitStack()
    stack.enter_context(planted("repro_torch.core.lp", "cluster_iteration",
                                make))
    stack.enter_context(planted("repro_torch.kernels.lp_move.ops",
                                "cluster_iteration_fused", make))
    return stack


def fault_half_batch():
    """Half of each clustering pass's chunks left out (the plain path the
    program takes on the CPU)."""
    def make(orig):
        def cluster_iteration(labels, cluster_w, src, dst, w, *a, **kw):
            h = max(1, src.shape[0] // 2)
            return orig(labels, cluster_w, src[:h], dst[:h], w[:h], *a,
                        **kw)
        return cluster_iteration
    return planted("repro_torch.core.lp", "cluster_iteration", make)


def fault_altered_answer():
    """One vertex's block altered where the answer is produced."""
    def make(orig):
        def partition(g, k, *a, **kw):
            part = orig(g, k, *a, **kw)
            part[g.n // 2] = (part[g.n // 2] + 1) % k
            return part
        return partition
    return planted("repro_torch.api.backends", "_single_partition", make)


def fault_unchanged_balance():
    """The balancer returns the partition it was given."""
    def make(orig):
        def rebalance(g, part, *a, **kw):
            return np.array(part, dtype=np.int64)
        return rebalance
    return planted("repro_torch.core.balance", "rebalance", make)


def fault_one_repetition():
    """The extension's bisections keep their first try instead of the best
    of the preset's repetitions, a saving that changes the answer."""
    def make(orig):
        def bipartition(g, k1, k2, l_max_final, rng, repetitions=3):
            return orig(g, k1, k2, l_max_final, rng, 1)
        return bipartition
    return planted("repro_torch.core.deep_mgp", "bipartition", make)


PLANTS = {"control": control, "unchanged_step": fault_unchanged_step,
          "half_batch": fault_half_batch,
          "altered_answer": fault_altered_answer,
          "unchanged_balance": fault_unchanged_balance,
          "one_repetition": fault_one_repetition}


def main(argv) -> int:
    from . import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--plant", choices=sorted(PLANTS), default="control")
    args = p.parse_args(argv)
    man = harness.manifest()
    cell, config, traffic, e2e, layer = harness.cell_of(man, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        with PLANTS[args.plant]():
            out = harness.run_cell(run, cell, config, traffic, e2e, [],
                                   "cuda", time.perf_counter())
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": out["correct"],
                          "requests": out["attempted"],
                          "checks": {k: v["value"] for k, v in
                                     out["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    from pathlib import Path
    REPO = Path(__file__).resolve().parent.parent
    sys.path[0] = str(REPO)
    sys.path.insert(1, str(REPO / "src"))
    from bench.control import main as control_main
    sys.exit(control_main(sys.argv[1:]))
