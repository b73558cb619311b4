#!/usr/bin/env python3
"""The heavy-row kernels' width classes on one GPU: a sweep of thresholds.

    python3 benchmarks/torch_heavy_sweep.py [--n N]

Builds ``csrc/lp_move.cu`` and ``csrc/bal_round.cu`` once for each
(WARP_LANES, HEAVY_WARPS) below, from copies of the sources with the
constants of ``csrc/common.cuh`` changed (HUB_RANGE = WARP_LANES x
HEAVY_WARPS, as the kernels require), into ``build/heavy_sweep/``, and
sets ``kernels/heavy.py``'s constants to match before each ELL build.
For ba and rhg at n (default 2^20, seed 17) it times, on each build:
``lp_move``'s heavy call on the first level-0 chunk (each vertex its own
cluster, as in the first clustering iteration) and ``bal_scores``' on the
finest level's ELL with 16 random blocks; each call's device ms (behind
a sleep kernel) and its heavy-row kernel's own device ms
(``chip_smoke.node_ms``). Prints one JSON line a (graph, thresholds).
Needs one CUDA device and ``nvcc``; exits non-zero without a device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
SWEEP = ((256, 4), (128, 4), (128, 8))    # (WARP_LANES, HEAVY_WARPS)


def build_variant(build, wl: int, hw: int, sigs):
    """The two libraries with these thresholds, loaded: {name: CDLL}."""
    out = ROOT / "build" / "heavy_sweep" / f"{wl}_{hw}"
    out.mkdir(parents=True, exist_ok=True)
    common = (CSRC / "common.cuh").read_text()
    for name, old, new in (("HEAVY_WARPS", 4, hw), ("WARP_LANES", 256, wl),
                           ("HUB_RANGE", 1024, wl * hw)):
        text = f"constexpr int {name} = {old};"
        assert text in common, text
        common = common.replace(text, f"constexpr int {name} = {new};")
    (out / "common.cuh").write_text(common)
    libs = {}
    for name, sig in sigs.items():
        src = (CSRC / f"{name}.cu").read_text().replace(
            "constexpr int PMAX = 5;",
            f"constexpr int PMAX = {wl * hw // (wl + 1) + 2};")
        (out / f"{name}.cu").write_text(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                        str(out / f"{name}.so"), str(out / f"{name}.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="vertices of each hub graph")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_heavy_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import _build as build
    from repro_torch.kernels import heavy
    from repro_torch.kernels.bal_round import bal_round
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.lp_move import lp_move
    from repro_torch.kernels.lp_move import ops as lp_ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cs.say(f"== torch_heavy_sweep: {smi}")
    variants = {v: build_variant(build, *v, {"lp_move": lp_move._SIG,
                                            "bal_round": bal_round._SIG})
                for v in SWEEP}
    load = build.load

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)
                                ).to(dev)

    rng = np.random.default_rng(1)
    for fam in ("ba", "rhg"):
        g = api.GraphSpec(fam, opts.n, 8.0, seed=17).materialize()
        for (wl, hw), libs in variants.items():
            heavy.WARP_LANES, heavy.HUB_RANGE = wl, wl * hw
            lp_move._scratch_bytes.cache_clear()
            build.load = lambda name, sig, libs=libs: libs[name]
            try:
                mc = lp_ops.build_move_chunks(g, 4)
                ov, idx = mc.overflow[0], mc.idx[0]
                R = idx.shape[0]
                ncw = np.where(idx >= 0, 1, 2**31 - 1)
                args = [t(idx), t(mc.w[0]), t(ncw),
                        t(np.minimum(np.arange(R), g.n)), t(np.ones(R)), 40,
                        0, 777, g.n + 1]
                over = tuple(t(x) for x in (ov.rows, ov.ptr, ov.idx, ov.w,
                                            np.ones(ov.idx.size), ov.hubs,
                                            ov.ranges))
                lp_call = (lambda: lp_move.lp_move_chunk(*args,
                                                         overflow=over))
                bidx, bw_ell, bov = bal_ops.build_balance_ell(g, mc.n_pad)
                K, rows = 16, mc.n_pad + 1
                labels = rng.integers(0, K, rows)
                bw = np.bincount(labels, minlength=K)
                bt = [t(x) for x in (bidx, bw_ell, labels, np.ones(rows), bw,
                                     (bw * 0.99).astype(np.int64))]
                fb = bal_ops.fallback_table(bt[4], None, False)
                bo = tuple(t(x) for x in bov)
                bal_call = (lambda: bal_round.bal_scores(*bt, fb, g.n, 99,
                                                         overflow=bo))
                rec = dict(graph=fam, n=g.n, warp_lanes=wl, heavy_warps=hw,
                           hub_range=wl * hw, card=smi)
                for name, call, ov_ in (("lp_move", lp_call, ov),
                                        ("bal_scores", bal_call, bov)):
                    rec[name] = dict(
                        heavy_rows=int(ov_.rows.size),
                        hub_ranges=int(ov_.ranges.size),
                        heavy_kernel_ms=cs.node_ms(torch, call, 1)[0],
                        device_ms=cs.device_ms(torch, [call], 20))
            finally:
                build.load = load
            cs.say(json.dumps(rec, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
