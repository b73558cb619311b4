#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port only (never the JAX package) through these phases and
exits non-zero if any one fails:

  1. environment: build the CUDA kernels from ``src/repro_torch/csrc``
     (one nvcc per source, all started together), print the build time,
     the torch/CUDA versions and the card's name and power limit;
  2. ragged kernel cases: every kernel against its plain PyTorch version
     on small edge-case inputs, exact equality;
  3. the anchor: rgg2d n=4000, k=16, eps=0.03 with the benchmark config
     (C=256, 4 chunks, 2 IP repetitions) must give cut 819, feasible,
     under ``kernel="fused"`` and ``kernel="composed"``;
  4. the main path: ``Partitioner(backend="single").run`` on rgg2d
     n=2^20, k=16, preset ``fast``, fused, must give cut 15465 (the JAX
     reference's), feasible, with every kernel launched (launch counts
     zeroed just before the run, read just after it). The port has no
     fused-to-composed fallback: a fused call launches its kernel or
     raises;
  5. each kernel against its plain version on the largest input the main
     path gave it (captured during phase 4), exact equality, both timed
     with CUDA events; beyond the main path, seg_merge at 2^24 records
     and the balancer at the finest level (a skewed partition, its own
     launch counts printed apart).

The line before the last is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's sources beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ANCHOR_CUT = 819          # rgg2d 4000, k=16, bench config (BENCH_api.json)
FULL_N = 1 << 20
# rgg2d 2^20, k=16, preset fast: the JAX reference's cut on this tree
# (tests/test_torch_e2e.py::test_full_size_on_gpu_matches_reference)
FULL_CUT = 15465
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM, non-tensor 32-bit rate

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "lp_move": ("src/repro_torch/csrc/lp_move.cu",
                "src/repro/kernels/lp_move/lp_move.py:197"),
    "seg_merge": ("src/repro_torch/csrc/seg_merge.cu",
                  "src/repro/kernels/seg_merge/seg_merge.py:117"),
    "bal_scores": ("src/repro_torch/csrc/bal_round.cu",
                   "src/repro/kernels/bal_round/bal_round.py:120"),
    "greedy_pick": ("src/repro_torch/csrc/bal_round.cu",
                    "src/repro/kernels/bal_round/bal_round.py:182"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def phase_environment(torch, build):
    say("== phase 1: environment")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    secs = build.build_all()
    say(f"kernel build {secs:.2f} s")
    for name in build.SOURCES:
        for line in (build.build_log(name) or "").splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                say(f"  {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: ragged kernel cases
# ---------------------------------------------------------------------------

def _i32(torch, x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def ragged_cases(torch, rng, dev):
    """(kernel, fn, plain, args) edge cases: odd row counts and widths,
    fully padded rows, sentinel lanes, duplicate and I32_MAX keys, record
    counts on both sides of the sort's shared-memory tile."""
    from repro_torch.kernels.bal_round import bal_round, ref as bal_ref
    from repro_torch.kernels.lp_move import lp_move, ref as lp_ref
    from repro_torch.kernels.seg_merge import ref as seg_ref, seg_merge

    cases = []
    for R, D, nl, W, dist in ((1, 1, 3, 2, False), (67, 5, 9, 6, False),
                              (300, 40, 30, 12, False), (129, 33, 20, 9, True),
                              (4099, 24, 500, 20, False)):
        nlab = rng.integers(0, nl, (R, D))
        nlab[rng.random((R, D)) < 0.3] = -1
        nlab = -np.sort(-nlab, axis=1)           # valid lanes first
        nlab[R - R // 5:] = -1                   # fully padded tail rows
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        ncw = np.where(nlab >= 0, rng.integers(0, 2 * W + 2, (R, D)),
                       2**31 - 1)
        own = rng.integers(0, nl, R)
        vw = rng.integers(1, 4, R)
        nbud = rng.integers(0, 2 * W + 2, (R, D)) if dist else None
        args = [_i32(torch, x, dev) for x in (nlab, nw, ncw, own, vw)]
        v0 = int(rng.integers(0, 1000))
        salt = int(rng.integers(0, 2**32))
        extra = dict(nbud=_i32(torch, nbud, dev)) if dist else {}
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, v0, salt, nl), extra))
    for L, span in ((1, 3), (3, 2), (1000, 40), (5000, 300), (70001, 2000)):
        src = rng.integers(0, span, L)
        dst = rng.integers(0, span, L)
        inv = rng.random(L) < 0.1
        src[inv] = dst[inv] = 2**31 - 1
        w = np.where(inv, 0, rng.integers(1, 9, L))
        cases.append(("seg_merge", seg_merge.seg_merge,
                      seg_ref.seg_merge_ref,
                      tuple(_i32(torch, x, dev) for x in (src, dst, w)), {}))
    for R, D, K, restricted in ((1, 1, 4, False), (77, 9, 64, False),
                                (513, 33, 64, True), (2000, 20, 128, False)):
        nlab = rng.integers(0, K, (R, D))
        nlab[rng.random((R, D)) < 0.3] = -1
        nlab = -np.sort(-nlab, axis=1)
        nlab[R - R // 4:] = -1
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        nbw = rng.integers(0, 50, (R, D))
        nlm = rng.integers(20, 60, (R, D))
        cols = [rng.integers(0, K, R), rng.integers(0, 7, R),
                rng.integers(0, 2, R), rng.integers(0, 2, R),
                rng.integers(0, K, R), rng.integers(0, 2, R)]
        args = [_i32(torch, x, dev) for x in (nlab, nw, nbw, nlm, *cols)]
        salt = int(rng.integers(0, 2**32))
        extra = {}
        if restricted:
            par = rng.integers(0, K // 2, K)
            extra = dict(npar=_i32(torch, par[np.maximum(nlab, 0)], dev),
                         opar=_i32(torch, par[cols[0]], dev))
        cases.append(("bal_scores", bal_round.bal_scores,
                      bal_ref.bal_scores_ref, (*args, salt), extra))
    for M, K in ((128, 64), (5, 3), (128, 1024), (128, 8192)):
        vals = np.sort(rng.normal(size=M).astype(np.float32))[::-1].copy()
        vals[M - M // 4:] = -np.inf
        bw = rng.integers(0, 100, K)
        lm = rng.integers(40, 80, K)
        args = (torch.from_numpy(vals).to(dev),
                *(_i32(torch, x, dev) for x in (
                    rng.integers(0, K, M), rng.integers(0, K, M),
                    rng.integers(1, 10, M), bw, lm)))
        cases.append(("greedy_pick", bal_round.greedy_pick,
                      bal_ref.greedy_pick_ref, args, {}))
    return cases


def max_abs_err(got, want) -> float:
    """Largest |got - want| over all outputs (0.0 iff bit-identical;
    equal infinities count as equal)."""
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"output shape/dtype {tuple(a.shape)}/{a.dtype} vs "
              f"{tuple(b.shape)}/{b.dtype}")
        diff = a != b
        if bool(diff.any()):
            d = (a[diff].double() - b[diff].double()).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
            err = err or float("inf")
    return err


def phase_ragged(torch, dev):
    say("== phase 2: ragged kernel cases against the plain versions "
        "(tolerance 0)")
    rng = np.random.default_rng(20260)
    for name, fn, plain, args, kw in ragged_cases(torch, rng, dev):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        err = max_abs_err(got, want)
        shape = tuple(args[0].shape)
        check(err == 0.0, f"{name} {shape}: kernel != plain, max abs err "
                          f"{err}")
        say(f"  {name} {shape}: exact")


# ---------------------------------------------------------------------------
# phases 3-4: the anchor and the main path
# ---------------------------------------------------------------------------

def run_partition(api, spec, k, kernel, *, config=None, preset="fast"):
    req = api.PartitionRequest(graph=spec, k=k, epsilon=0.03,
                               preset=preset, config=config, kernel=kernel)
    return api.Partitioner(backend="single").run(req)


def phase_anchor(torch, api, deep_mgp):
    say("== phase 3: anchor rgg2d 4000, k=16, bench config")
    cfg = deep_mgp.PartitionerConfig(contraction_limit=256,
                                     ip_repetitions=2, num_chunks=4)
    spec = api.GraphSpec("rgg2d", 4000, 8.0, seed=17)
    cuts = {}
    for kernel in ("fused", "composed"):
        t0 = time.perf_counter()
        res = run_partition(api, spec, 16, kernel, config=cfg)
        torch.cuda.synchronize()
        cut = int(res.metrics["cut"])
        say(f"  {kernel}: cut {cut} feasible {res.feasible} "
            f"{time.perf_counter() - t0:.3f} s")
        check(res.feasible and cut == ANCHOR_CUT,
              f"anchor ({kernel}): cut {cut}, feasible {res.feasible}; "
              f"expected {ANCHOR_CUT}, feasible")
        cuts[kernel] = res.assignment
    check(np.array_equal(cuts["fused"], cuts["composed"]),
          "anchor: fused and composed assignments differ")


class Capture:
    """Wraps the kernel wrappers the core calls and keeps a copy of the
    largest input each one was given (the main path's shapes)."""

    def __init__(self, torch):
        self.torch = torch
        self.inputs = {}
        self._undo = []

    def wrap(self, module, attr, name):
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            size = args[0].numel()
            if size >= self.inputs.get(name, (-1,))[0]:
                cl = (lambda x: x.clone() if isinstance(
                    x, self.torch.Tensor) else x)
                self.inputs[name] = (size, fn, [cl(a) for a in args],
                                     {k: cl(v) for k, v in kw.items()})
            return fn(*args, **kw)

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def restore(self):
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


def phase_main_path(torch, api, build):
    say(f"== phase 4: main path rgg2d {FULL_N}, k=16, preset fast, fused")
    spec = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17)
    t0 = time.perf_counter()
    g = spec.materialize()
    say(f"  graph n={g.n} m={g.m} max_deg={int(g.degrees().max())} "
        f"({time.perf_counter() - t0:.2f} s, set-up)")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_partition(api, g, 16, "fused")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)    # the main path's run and no other
    wall = time.perf_counter() - t0
    cut = int(res.metrics["cut"])
    say(f"  cut {cut} feasible {res.feasible} imbalance "
        f"{res.metrics.get('imbalance')} wall {wall:.3f} s peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for rec in res.trace:
        say("  trace " + json.dumps(rec, sort_keys=True))
    say(f"  launches {json.dumps(launches, sort_keys=True)}")
    check(res.feasible and cut == FULL_CUT,
          f"main path: cut {cut}, feasible {res.feasible}; expected "
          f"{FULL_CUT}, feasible")
    for name in KERNELS:
        check(launches[name] > 0, f"main path: {name} was never launched")
    return g, launches, res.assignment


def skewed_rebalance(g, assignment, dev) -> int:
    """Rebalance the finest level after moving 2000 vertices of block 1
    into block 0 (an overload a few pool rounds repair); returns the
    number of rounds."""
    from repro_torch.core import balance, metrics

    part = np.asarray(assignment).copy()
    part[np.flatnonzero(part == 1)[:2000]] = 0
    l_final = metrics.l_max(g.total_vweight, 16, 0.03,
                            int(g.vweights.max()))
    stats = {}
    out = balance.rebalance(g, part, np.full(16, l_final, dtype=np.int64),
                            kernel="fused", device=dev, stats=stats)
    check(metrics.is_feasible(g, out, 16, 0.03),
          "the balancer left the skewed partition infeasible")
    return stats["rounds"]


# ---------------------------------------------------------------------------
# phase 5: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(kind: str, args, kw, out):
    """(bound_ms, bound_by): the larger of bytes moved (each input read
    once, each output written once) over HBM bandwidth and the
    operations these inputs need over the card's 32-bit rate.

    The ELL kernels (lp_move, bal_scores) need only the valid lanes of
    their (R, D) slabs, a prefix of each row: a slab counts sum(deg)
    lanes, not R * D."""
    tensors = [a for a in args if hasattr(a, "numel")]
    tensors += [v for v in kw.values() if v is not None]
    if kind in ("lp_move", "bal_scores"):
        deg = (args[0] >= 0).sum(1).double()
        lanes = int(deg.sum())
        slabs = [t for t in tensors if t.dim() == 2]
        cols = [t for t in tensors if t.dim() != 2]
        moved = lanes * sum(t.element_size() for t in slabs) \
            + nbytes(*cols) + nbytes(*out)
        # label-equality connectivity: deg^2 compare-adds per row,
        # plus ~16 ops per lane for admission and the tie chain
        ops = float((2 * deg * deg + 16 * deg).sum())
    elif kind == "seg_merge":
        moved = nbytes(*tensors) + nbytes(*out)
        # a comparison sort needs L log2 L compares; flags and run
        # totals a few more per record
        L = args[0].numel()
        ops = float(L * max(1, (L - 1).bit_length()) + 4 * L)
    else:
        moved = nbytes(*tensors) + nbytes(*out)
        ops = float(12 * args[0].numel())        # one guarded step each
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_seg_merge(torch, g, dev):
    """2^24 padded records: the fine graph's arcs merged in vertex pairs
    (``v // 2``), so runs of duplicates and self loops both occur."""
    src = torch.from_numpy((g.arc_tails() // 2).astype(np.int32)).to(dev)
    dst = torch.from_numpy((g.adjncy // 2).astype(np.int32)).to(dev)
    w = torch.from_numpy(g.eweights.astype(np.int32)).to(dev)
    return [src, dst, w], {}


def phase_kernels(torch, build, capture, launches, g, assignment, dev):
    say("== phase 5: kernels against their plain versions at main-path "
        "shapes (tolerance 0: every output, rel included, bit-identical)")
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.kernels.seg_merge import ref as seg_ref
    from repro_torch.kernels.seg_merge import seg_merge as seg_mod

    plain = {"lp_move": lp_ref.lp_move_chunk_ref,
             "seg_merge": seg_ref.seg_merge_ref,
             "bal_scores": bal_ref.bal_scores_ref,
             "greedy_pick": bal_ref.greedy_pick_ref}
    runs = [(name, *capture.inputs[name][1:]) for name in KERNELS]
    # beyond the main path's own inputs (printed, not in the record):
    # seg_merge at 2^24 padded records, the balancer at the finest level
    sa, skw = synthetic_seg_merge(torch, g, dev)
    runs.append(("seg_merge", seg_mod.seg_merge, sa, skw))
    finest = Capture(torch)
    finest.wrap(bal_ops, "bal_scores", "bal_scores")
    finest.wrap(bal_ops, "greedy_pick", "greedy_pick")
    build.reset_launches()
    try:
        rounds = skewed_rebalance(g, assignment, dev)
    finally:
        finest.restore()
    say(f"  finest-level balancer on a skewed partition: {rounds} rounds, "
        f"launches {json.dumps(dict(build.LAUNCHES), sort_keys=True)} "
        "(not the main path's)")
    runs += [(name, *finest.inputs[name][1:])
             for name in ("bal_scores", "greedy_pick")]
    rows = {}
    for name, fn, args, kw in runs:
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        shape = tuple(args[0].shape)
        check(err == 0.0, f"{name} {shape}: kernel != plain at main-path "
                          f"shape, max abs err {err}")
        reps = 20 if name != "greedy_pick" else 200
        ms = cuda_ms(torch, lambda: fn(*args, **kw), reps)
        plain_ms = cuda_ms(torch, lambda: plain[name](*args, **kw),
                           max(2, reps // 10))
        b_ms, b_by = bound(name, args, kw, got)
        say(f"  {name} {shape}: exact; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if name in rows:   # beyond the main path: printed only
            continue
        src, replaces = KERNELS[name]
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None, "shape": list(shape)}
    return [rows[name] for name in KERNELS]


def main() -> int:
    import torch

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core import deep_mgp
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.seg_merge import ops as seg_ops

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in the JAX package")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    smi = phase_environment(torch, build)
    phase_ragged(torch, dev)
    phase_anchor(torch, api, deep_mgp)
    capture = Capture(torch)
    capture.wrap(lp_ops, "lp_move_chunk", "lp_move")
    capture.wrap(seg_ops, "seg_merge", "seg_merge")
    capture.wrap(bal_ops, "bal_scores", "bal_scores")
    capture.wrap(bal_ops, "greedy_pick", "greedy_pick")
    try:
        g, launches, assignment = phase_main_path(
            torch, api, build)
    finally:
        capture.restore()
    kernels = phase_kernels(torch, build, capture, launches, g, assignment,
                            dev)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in the JAX package")
    say(f"total {time.perf_counter() - t_all:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
