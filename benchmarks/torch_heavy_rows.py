#!/usr/bin/env python3
"""The heavy-row calls of the PyTorch/CUDA port on one GPU, for one tree.

    python3 benchmarks/torch_heavy_rows.py [--src DIR] [--n N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and the measuring helpers of this checkout's ``chip_smoke.py``, so that
two trees (a change and its parent, unpacked with ``git archive``) are
measured by the same code in one run on one card. For ba and rhg at n
(default 2^20; seed 17, k=16, preset ``fast``) it runs the fused
partitioner with the ``lp_move`` and ``bal_scores`` calls captured, keeps
the call of each with the most heavy-row lanes (slab and overflow), holds
it to its plain version and prints one JSON line: per call its heavy
rows and lanes, wrapper ms (CUDA events over 20 back-to-back calls),
device launches (nodes of a captured CUDA graph), device ms (behind a
sleep kernel) and the heavy-row kernel's own device ms (torch.profiler,
None when the window recorded nothing); and each run's cut and wall.
Needs one CUDA device; exits non-zero without one.
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
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="vertices of each hub graph")
    opts = ap.parse_args()
    src = Path(opts.src).resolve()
    import torch

    if not torch.cuda.is_available():
        print("torch_heavy_rows: no CUDA device", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"torch_heavy_rows: no repro_torch under {src}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(src), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.bal_round.ref import bal_scores_ell_ref
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move.ref import lp_move_chunk_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.say(f"== torch_heavy_rows: repro_torch from {src}; {smi}")
    build.build_all()
    out = {"src": str(src), "card": smi, "n": opts.n}
    plain = {"lp_move_heavy": lp_move_chunk_ref,
             "bal_scores_heavy": bal_scores_ell_ref}
    for fam in ("ba", "rhg"):
        g = api.GraphSpec(fam, opts.n, 8.0, seed=17).materialize()
        cap = cs.Capture(torch)
        cap.wrap(lp_ops, "lp_move_chunk", "lp_move_heavy",
                 size=cs.heavy_lanes)
        cap.wrap(bal_ops, "bal_scores", "bal_scores_heavy",
                 size=cs.heavy_lanes)
        try:
            res, wall, _, launches = cs.hub_run(torch, api, build, g, "auto")
        finally:
            cap.restore()
        out[fam] = {"cut": int(res.cut), "wall_s": wall,
                    "launches": launches}
        cs.say(f"  {fam} n={g.n}: cut {res.cut}, wall {wall:.3f} s, "
               f"launches {json.dumps(launches, sort_keys=True)}")
        for name, (_, fn, args, kw) in sorted(cap.inputs.items()):
            ov = kw["overflow"]
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            err, _, _ = cs.compare(name, got, plain[name](*args, **kw))
            ms = cs.cuda_ms(torch, lambda: fn(*args, **kw), 20)
            rec = cs.heavy_device(torch, name, fn, args, kw,
                                  f"at the {fam} call",
                                  cs.HEAVY_LAUNCHES[name])
            rec.update(heavy_rows=ov[0].numel(),
                       lanes=cs.heavy_lanes(args, kw), wrapper_ms=ms,
                       max_abs_err=err)
            cs.say(f"  {fam} {name}: {rec['heavy_rows']} heavy rows, "
                   f"{rec['lanes']} lanes, exact; wrapper {ms:.4f} ms, "
                   f"device {rec['device_ms']:.4f} ms")
            out[fam][name] = rec
        del cap, g, res
    cs.say(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
