#!/usr/bin/env python3
"""The PyTorch/CUDA port's fused balancer on one GPU, for one source tree.

    python3 benchmarks/torch_balancer.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and the measuring helpers of this checkout's ``chip_smoke.py``, so that
two trees (for example a change and its parent, unpacked with ``git
archive``) are measured by the same code in one run on one card. It runs
the 2^20 main path (rgg2d n=2^20, k=16, preset ``fast``, fused; cut
15465) with the inputs of its ``bal_scores`` and ``greedy_pick`` calls
captured, then the finest-level balancer on that partition made
infeasible, and prints one JSON line: each kernel's device launches and
device time per call at the main path's call and at the finest level,
and the finest-level balancer's rounds, wall, peak device memory and its
last round's device time split into the score stage, the pool sort and
``greedy_pick``. Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package")
    src = Path(ap.parse_args().src).resolve()
    import torch

    if not torch.cuda.is_available():
        print("torch_balancer: no CUDA device", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"torch_balancer: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bal_round import ops as bal_ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.say(f"== torch_balancer: repro_torch from {src}; {smi}")
    build.build_all()
    g = api.GraphSpec("rgg2d", cs.FULL_N, 8.0, seed=17).materialize()
    cap = cs.Capture(torch)
    cap.wrap(bal_ops, "bal_scores", "bal_scores")
    cap.wrap(bal_ops, "greedy_pick", "greedy_pick")
    build.reset_launches()
    try:
        res = cs.run_partition(api, g, 16, "fused")
    finally:
        cap.restore()
    torch.cuda.synchronize()
    cut = int(res.metrics["cut"])
    cs.check(res.feasible and cut == cs.FULL_CUT,
             f"main path: cut {cut}, feasible {res.feasible}")
    out = {"src": str(src), "card": smi, "cut": cut,
           "main_path_launches": dict(build.LAUNCHES)}
    for name in ("bal_scores", "greedy_pick"):
        _, fn, args, kw = cap.inputs[name]
        out[f"{name}_main"] = cs.kernel_device(
            torch, name, fn, args, kw, "at the main path's call", None)
    del cap
    stats, finest = cs.finest_balancer(torch, build, g, res.assignment, dev)
    out["finest"] = stats
    out["finest"].update(cs.round_stages(torch, finest))
    for name in ("bal_scores", "greedy_pick"):
        _, fn, args, kw = finest.inputs[name]
        out[f"{name}_finest"] = cs.kernel_device(
            torch, name, fn, args, kw, "at the finest level", None)
    cs.say(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
