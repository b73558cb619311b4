#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port only (never the JAX package) through these phases and
exits non-zero if any one fails:

  1. environment: build the CUDA kernels from ``src/repro_torch/csrc``
     (one nvcc per source, all started together), print the build time,
     the torch/CUDA versions, the card's name and power limit, its SM
     clocks and the cycles of one dependent shared-memory load;
  2. ragged kernel cases: every kernel against its plain PyTorch version
     on small edge-case inputs, exact equality (bsr_spmm, whose sums run
     in another order, within rtol 1e-5 / atol 1e-5, its largest error
     printed as a share of that allowance, its finite ragged shapes also
     on eight more seeds); lp_move also on
     chunks that load its phase B (no candidate; every row a candidate to
     one target, R = 4,500 and 70,001; candidates spread over ~2^21
     labels; -1 lanes anywhere in a row), each also timed beside its
     count of candidates; seg_merge on ragged lengths, ids at a key-width
     boundary, I32_MAX in one half only, negative and full-width ids, one
     key over several tiles, all records invalid, wrapping run totals
     and L = 2^22 + 1; embedding_bag at D=64 with BAG 1, 4 and 17 and
     B not a multiple of its bags per thread; bsr_spmm with +-inf and NaN
     in X (one inf met only by zero weights, which the plain version
     turns into NaN), values beyond its TF32 split's range and an inf in
     A; lp_gain on operands built by its entry point at 32 and 128 lanes;
     bal_scores on the fused round's operands (ELL ids with -1 lanes
     first or anywhere, rows with no valid lane, hub rows of 160 and 256
     lanes, K = 8192 restricted, block tables summed from the labels);
     greedy_pick at K = 1, K = 2^20, pool ids out of [0, K) and M over
     three of its 512-entry passes;
  3. the anchor: rgg2d n=4000, k=16, eps=0.03 with the benchmark config
     (C=256, 4 chunks, 2 IP repetitions) must give cut 819, feasible,
     under ``kernel="fused"`` and ``kernel="composed"``;
  4. the main path: ``Partitioner(backend="single").run`` on rgg2d
     n=2^20, k=16, preset ``fast``, fused, must give cut 15465 (the JAX
     reference's), feasible, with every kernel launched (launch counts
     zeroed just before the run, read just after it). The port has no
     fused-to-composed fallback: a fused call launches its kernel or
     raises. Each lp_move call's count of phase-B candidates (by the plain
     version's rule on its inputs) is printed, and each seg_merge call's
     length, key width and radix passes; so are the seconds each trace
     phase spent in the host functions permute, degree_bucket_order,
     build_move_chunks, lp.build_chunks, contract and dedup_arcs (the
     module attributes wrapped, not edited);
  5. each kernel against its plain version on the largest input the main
     path gave it (captured during phase 4), exact equality, both timed
     with CUDA events; beyond the main path, seg_merge on the 2^20
     graph's 8,378,246 arcs merged in vertex pairs and the balancer at
     the finest level (a skewed partition, its own launch counts printed
     apart). lp_move's and seg_merge's device launches per call (nodes of
     a captured CUDA graph) must be the same at the main path's largest
     call and at 67 rows / 5 records of it, at most 12, and a call must
     not wait for the stream (``set_sync_debug_mode("error")``);
     seg_merge's device time is printed L2-warm and L2-cold (four input
     copies in turn), the plain version's alike, beside one torch.sort of
     its packed keys ("sort only", a yardstick); bal_scores and
     greedy_pick, at the main path's call and at the finest level, must
     make one device launch a call and wait for nothing, their device
     times printed; the finest-level balancer prints its rounds, wall and
     peak device memory, and its last round's device time split into the
     score stage, the pool sort and greedy_pick (greedy_pick's bound is
     its M dependent steps, each one shared-memory load-to-use latency,
     measured in phase 1 by a pointer chase, at the card's maximum SM
     clock);
  6. the kernels off the main path, each through its own entry point at
     full size on the default (CUDA) device, with launch counts zeroed
     just before and read just after each: ``lp_gain`` on the 2^20 graph
     with phase 4's assignment (labels, block weights, L_max), checked
     against an edge scan; ``spmm`` on grid2d 1024x1024 with F=128,
     checked against a COO sum in f64, with its device launches per call
     (a captured CUDA graph), its device time and the share of all-zero
     A sub-tiles it skips; lp_gain's lane
     width, slab bytes, and its kernel and entry-point times at the
     reference's 128 lanes beside its default 32 (the same bits);
     ``embedding_bag`` on one dlrm-rm2
     table (V=10^6, D=64, B=65,536, BAG 1 and 4), checked against a
     sequential numpy sum. Each kernel is held to its plain version on
     the inputs its entry point gave it (exact; bsr_spmm within rtol
     1e-5 / atol 1e-5) and timed beside its bound and, for bsr_spmm and
     embedding_bag, the PyTorch library call that computes the same
     function (a yardstick the port never calls). embedding_bag's row is
     the launch path its entry point uses (indices checked on the host),
     timed over 8 index sets in turn so that the gathered rows do not
     stay in L2 (the library call alike), with the checked wrapper's
     time, its device launches per call, its device time L2-cold and
     L2-warm and the no-stream-wait check printed beside it;
  7. the unconstrained refinement tier, the baselines, the CLI and a
     session. First ``PartitionSession(devices=1, max_workers=4)
     .run_batch`` of rgg2d n=2000 (graph seeds 0-2, k=8, C=64, and seed 0
     again with ``quality="best"``) with the kernels loaded anew from a
     fresh build directory, so that the build lock meets concurrent first
     loads: nvcc must run at most once a source, every result must equal
     a solo run's and the reference's cut. Then ``Partitioner(backend=
     "single").run`` of phase 4's request with ``refine="unconstrained"``
     (launch counts zeroed just before and read just after; every
     main-path kernel launched): cut, feasibility, the per-level trace and
     every ``refine-mode`` record (penalty, repair rounds) must equal the
     JAX reference's (``benchmarks/torch_reference_anchors.py``), printed
     with its wall and per-phase times beside phase 4's and every
     rebalance call's rounds and seconds (the afterburner's), and each of the
     four kernels held to its plain version on the largest input this run
     gave it; ``Partitioner.compare`` of the same request against
     ``plain_mgp`` and ``single_level_lp`` must give the reference's cuts,
     feasible; ``python -m repro_torch.launch.partition --family rgg2d
     --n 4000 --k 16 --compare --trace`` must exit 0 with three summary
     lines of the reference CLI's cuts;
  8. serving. (a) The stacked level-0 clustering of three requests on
     phase 4's graph (request seeds 0-2, k=16, preset fast) with
     ``kernel="fused"`` must equal the composed stacked form on the card
     and three solo ``cluster(kernel="fused")`` calls, in 24 stacked
     ``lp_move`` calls and no solo one; one stacked call at the level-0
     chunk shape (S=3, R=262,144, D=32) is held to its plain version
     (exact), to the three solo calls of the same chunks, timed (wrapper
     and device time) beside those three calls, its device launches
     counted (a captured graph: as many as a solo call's) and its bound
     printed: the three requests' valid lanes over 3.35 TB/s. (b) A
     burst through ``PartitionServer(meshes=2, batch_max=8,
     batch_window_ms=50)``: rgg2d n=65,536, k=16, fast, request seeds
     0-5 twice (priorities 0/1) and seed 0 with ``quality="best"`` and a
     600 s deadline, which admission downgrades to fast: every result ok
     and equal to a solo run, the stacked kernel launched; its stats and
     launch counts printed. (c) ``PartitionSession(stack="auto")
     .submit_many`` of seed 0 fast, seed 1 fast, seed 0 best and seed 0
     fast again on phase 4's graph: cuts 15465 and 15308 for seed 0, the
     assignments of phases 4 and 7, seed 1 its solo run's, the duplicate
     coalesced, the three distinct level 0s stacked (launch counts
     checked), the batch's wall beside the solo walls. (d) ``python -m
     repro_torch.launch.serve --meshes 2 --requests 12 --n 4000 --k 8
     --verify`` must exit 0.

The line before the last is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's sources beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
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
# the same request with refine="unconstrained", and its comparison: the
# JAX reference's answers on the CPU (kernel="composed"), from
# benchmarks/torch_reference_anchors.py. The trace as (phase, level, n, m,
# coarse_n or blocks, W or cut); REPAIR_ROUNDS per refine-mode record
# (stage, level), each with the penalty schedule [0.0, 0.5]
UNCONSTRAINED_CUT = 15308
UNCONSTRAINED_TRACE = (
    ("coarsen", 0, 1048576, 8378246, 136674, 1966),
    ("coarsen", 1, 136674, 553112, 39641, 1966),
    ("coarsen", 2, 39641, 175650, 13227, 1966),
    ("coarsen", 3, 13227, 60980, 5129, 5242),
    ("coarsen", 4, 5129, 21072, 2343, 15728),
    ("initial", None, 2343, 6818, 2, 1050),
    ("uncoarsen", 0, 5129, 21072, 2, 986),
    ("uncoarsen", 1, 13227, 60980, 8, 6454),
    ("uncoarsen", 2, 39641, 175650, 16, 15988),
    ("uncoarsen", 3, 136674, 553112, 16, 15688),
    ("uncoarsen", 4, 1048576, 8378246, 16, 15310),
    ("final", None, 1048576, 8378246, 16, UNCONSTRAINED_CUT),
)
REPAIR_ROUNDS = {("initial", None): 0, ("uncoarsen", 0): 0,
                 ("uncoarsen", 1): 0, ("uncoarsen", 2): 2,
                 ("uncoarsen", 3): 0, ("uncoarsen", 4): 0,
                 ("final", None): 0}
BASELINE_CUTS = {"plain_mgp": 8781, "single_level_lp": 724032}
# the reference CLI: rgg2d 4000 (seed 0), k=16, --compare
CLI_CUTS = {"single": 916, "plain_mgp": 876, "single_level_lp": 2759}
# rgg2d 2000, k=8, C=64: graph seed -> the reference's cut; seed 0 with
# quality="best" gives 186
SESSION_CUTS = {0: 169, 1: 335, 2: 212}
SESSION_BEST_CUT = 186
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM, non-tensor 32-bit rate

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "lp_move": ("src/repro_torch/csrc/lp_move.cu",
                "src/repro/kernels/lp_move/lp_move.py:197"),
    # the same TPU kernel, with the request axis the reference adds by
    # jax.vmap (core/lp.py:258 cluster_iteration_stacked)
    "lp_move_stacked": ("src/repro_torch/csrc/lp_move.cu",
                        "src/repro/kernels/lp_move/lp_move.py:197"),
    "seg_merge": ("src/repro_torch/csrc/seg_merge.cu",
                  "src/repro/kernels/seg_merge/seg_merge.py:117"),
    "bal_scores": ("src/repro_torch/csrc/bal_round.cu",
                   "src/repro/kernels/bal_round/bal_round.py:120"),
    "greedy_pick": ("src/repro_torch/csrc/bal_round.cu",
                    "src/repro/kernels/bal_round/bal_round.py:182"),
    "lp_gain": ("src/repro_torch/csrc/lp_gain.cu",
                "src/repro/kernels/lp_gain/lp_gain.py:70"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm/bsr_spmm.py:47"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/embedding_bag.py:35"),
}
MAIN_PATH = ("lp_move", "seg_merge", "bal_scores", "greedy_pick")
# (rtol, atol) of a kernel against its plain version; the rest are exact
TOLERANCE = {"bsr_spmm": (1e-5, 1e-5)}
# measured in phase 1: cycles of one dependent shared-memory load, and the
# card's maximum SM clock (MHz); greedy_pick's bound reads them
CARD = {}


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
    measure_step_latency(torch)
    return smi


def sm_clocks():
    """(maximum, current) SM clock of card 0 in MHz, as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    mx, cur = (float(x) for x in out.split(","))
    return mx, cur


def measure_step_latency(torch):
    """Fill CARD with what greedy_pick's bound needs: the cycles of one
    dependent shared-memory load (a pointer chase on the card, median of
    five) and the card's maximum SM clock."""
    from repro_torch.kernels.bal_round import bal_round

    dev = torch.device("cuda", 0)
    cycles = float(np.median([bal_round.smem_load_cycles(dev)
                              for _ in range(5)]))
    mx, cur = sm_clocks()
    CARD.update(smem_load_cycles=cycles, sm_clock_mhz=mx)
    say(f"shared-memory load-to-use latency {cycles:.2f} cycles (pointer "
        f"chase, median of 5); SM clock max {mx:.0f} MHz (now {cur:.0f})")


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
    for kind, R, dist in (("none", 5000, False), ("none", 5000, True),
                          ("one_target", 4500, False),
                          ("one_target", 4500, True),
                          ("one_target", 70001, False),
                          ("spread", 20000, False), ("spread", 20000, True),
                          ("holes", 3000, False), ("holes", 3000, True)):
        nlab, nw, ncw, nbud, own, vw, W, nl = lp_move_stress(rng, kind, R,
                                                             dist)
        args = [_i32(torch, x, dev) for x in (nlab, nw, ncw, own, vw)]
        extra = dict(nbud=_i32(torch, nbud, dev)) if dist else {}
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, int(rng.integers(0, 1000)),
                       int(rng.integers(0, 2**32)), nl), extra,
                      f"phase B {kind}{' nbud' if dist else ''}"))
    for kind, L, span in seg_merge_cases():
        src, dst, w, max_id = seg_merge_records(rng, kind, L, span)
        cases.append(("seg_merge", seg_merge.seg_merge,
                      seg_ref.seg_merge_ref,
                      tuple(_i32(torch, x, dev) for x in (src, dst, w)),
                      dict(max_id=max_id),
                      f"{kind}, key bits {seg_ref.key_bits(max_id)}"))
    for R, D, K, restricted, what in BAL_RAGGED:
        args, kw = bal_scores_operands(torch, rng, dev, R, D, K, restricted,
                                       what)
        cases.append(("bal_scores", bal_round.bal_scores,
                      bal_ref.bal_scores_ell_ref, args, kw,
                      *([what] if what else [])))
    for M, K, what in ((128, 64, ""), (5, 3, ""), (128, 1024, ""),
                       (128, 8192, ""), (128, 1, "K=1"),
                       (128, 2**20, "K=2^20, beyond any CTA's staging"),
                       (200, 50, "ids out of [0, K)"),
                       (1300, 300, "M over three 512-entry passes")):
        vals = np.sort(rng.normal(size=M).astype(np.float32))[::-1].copy()
        vals[M - M // 4:] = -np.inf
        bw = rng.integers(0, 100, K)
        lm = rng.integers(40, 80, K)
        lo, hi = (-3, K + 3) if what.startswith("ids") else (0, K)
        cw = rng.integers(1, 10, M)
        if K == 1:        # ids beside 0, an overloaded block, weights < 0
            lo, hi, bw = -2, 3, lm + 5
            cw -= 9
        args = (torch.from_numpy(vals).to(dev),
                *(_i32(torch, x, dev) for x in (
                    rng.integers(lo, hi, M), rng.integers(lo, hi, M), cw,
                    bw, lm)))
        cases.append(("greedy_pick", bal_round.greedy_pick,
                      bal_ref.greedy_pick_ref, args, {},
                      *([what] if what else [])))
    return cases + micro_ragged_cases(torch, rng, dev)


# bal_scores' ragged cases: (R, D, K, restricted, what); "holes" puts -1
# lanes anywhere in a row, "empty" gives a third of the rows below n no
# valid lane; D = 100 holds 4 tiles in registers, 160 and 256 walk a row's
# tiles from memory
BAL_RAGGED = ((1, 1, 4, False, ""), (77, 9, 64, False, ""),
              (513, 33, 64, True, "holes"), (2000, 20, 128, False, ""),
              (1000, 70, 32, True, "holes"), (700, 100, 64, False, "holes"),
              (300, 160, 16, False, "hub row, D=160"),
              (300, 256, 16, True, "hub row, D=256"),
              (4000, 24, 8192, True, "K=8192"),
              (3000, 32, 64, False, "empty"))


def bal_scores_operands(torch, rng, dev, R, D, K, restricted, what):
    """(args, kw) of one bal_scores call in the fused round's form: ELL ids
    (valid lanes first, or anywhere for "holes"; rows >= n padded) and
    weights, labels skewed to block 0, vertex weights, block weights
    summed from those labels, budgets that leave block 0 and some others
    overloaded, the parent groups (restricted) and the fallback table the
    fused round composes."""
    from repro_torch.kernels.bal_round import ops as bal_ops

    n = R - R // 4
    idx = rng.integers(0, R, (R, D))
    idx[rng.random((R, D)) < 0.3] = -1
    if what != "holes":
        idx = -np.sort(-idx, axis=1)             # valid lanes first
    if what.startswith("hub"):
        idx[R // 3] = rng.integers(0, R, D)      # every lane valid
    if what == "empty":
        idx[rng.random(R) < 1 / 3] = -1
    idx[n:] = -1
    w = np.where(idx >= 0, rng.integers(1, 6, (R, D)), 0)
    labels = rng.integers(0, K, R)
    labels[rng.random(R) < 0.3] = 0
    vw = rng.integers(1, 7, R)
    bw = np.bincount(labels[:n], weights=vw[:n], minlength=K)
    lm = (bw.sum() / K * rng.uniform(0.9, 1.3, K)).astype(np.int64)
    par = rng.integers(0, max(1, K // 4), K)
    t = [_i32(torch, x, dev) for x in (idx, w, labels, vw, bw, lm, par)]
    fb = bal_ops.fallback_table(t[4], t[6], restricted)
    salt = int(rng.integers(0, 2**32))
    return (*t[:6], fb, n, salt), (dict(parent=t[6]) if restricted else {})


def seg_merge_cases():
    """(kind, L, id span) of phase 2's seg_merge cases: ragged lengths
    (none a power of two but 1), ids at a key-width boundary, I32_MAX in
    one half only, negative ids, one key over several 4096-key tiles,
    all records invalid, run totals that wrap int32, L = 2^22 + 1, and
    full-width ids near 2^31 - 2."""
    return (("random", 1, 3), ("random", 3, 2), ("random", 1000, 40),
            ("random", 5000, 300), ("random", 70001, 2000),
            ("width", 3000, 128), ("one_half", 5000, 300),
            ("negative", 9999, 10000), ("long_run", 20000, 50),
            ("all_invalid", 3333, 1), ("wrap", 6000, 30),
            ("random", 2**22 + 1, 136674), ("full_width", 5000, 40),
            ("full_width_bound", 5000, 40))


def seg_merge_records(rng, kind, L, span):
    """(src, dst, w, max_id) of one seg_merge case; max_id is the bound
    the main path's caller passes (the largest valid id), None where ids
    are negative (full 32-bit key halves)."""
    I = 2**31 - 1
    src = rng.integers(0, span, L)
    dst = rng.integers(0, span, L)
    w = rng.integers(1, 9, L)
    max_id = span - 1
    if kind == "random":
        inv = rng.random(L) < 0.1
        src[inv] = dst[inv] = I
        w[inv] = 0
    elif kind == "width":          # a max id of 2^7 - 1 needs 8 bits
        src[:5] = dst[5:9] = span - 1
        dst[rng.random(L) < 0.1] = I
    elif kind == "one_half":
        src[rng.random(L) < 0.15] = I
        dst[rng.random(L) < 0.15] = I
    elif kind == "negative":
        src -= span // 2
        dst -= span // 2
        src[:7] = I
        max_id = None
    elif kind == "long_run":       # 12,000 copies of one key: 3 tiles
        take = rng.permutation(L)[:12000]
        src[take], dst[take] = 17, 4
    elif kind == "all_invalid":
        src[:] = dst[:] = I
        w[:] = 0
        max_id = 0
    elif kind == "wrap":
        w = rng.integers(2**29, 2**30, L)
    elif kind.startswith("full_width"):
        src = I - 1 - src
        dst = I - 1 - dst
        max_id = I - 1 if kind.endswith("bound") else None
    return src, dst, w, max_id


def lp_move_stress(rng, kind, R, dist):
    """An ``lp_move`` chunk that loads phase B: ``none`` has no candidate
    (W far above every cluster), ``one_target`` makes every row a mover
    to label 0 and so a candidate (one target, R of them), ``spread``
    puts many candidates on many targets among ~2^21 labels (a 52-bit
    key), ``holes`` has -1 lanes anywhere in a row, not only a suffix.
    Returns (nlab, nw, ncw, nbud, own, vw, W, num_labels); ``nbud``
    (the distributed admission form) only if ``dist``."""
    D = {"none": 16, "one_target": 4, "spread": 24, "holes": 40}[kind]
    if kind == "one_target":
        W, nl = 10, R + 1
        nlab = np.full((R, D), -1)
        nlab[:, 0] = 0
        ncw = np.where(nlab >= 0, 1, 2**31 - 1)
        nw = np.where(nlab >= 0, 3, 0)
        own = 1 + np.arange(R)
        vw = np.full(R, 2)
    else:
        W, nl = {"none": (10**6, 40), "spread": (40, 2**21 - 5),
                 "holes": (30, 50)}[kind]
        pool = rng.choice(nl, min(nl, max(2, R // 4)), replace=False)
        nlab = pool[rng.integers(0, pool.size, (R, D))]
        nlab[rng.random((R, D)) < 0.4] = -1      # holes anywhere in a row
        nlab[R - R // 8:] = -1                   # fully padded tail rows
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        lo, hi = (0, 20) if kind == "none" else (W // 2, W - 2)
        ncw = np.where(nlab >= 0, rng.integers(lo, hi, (R, D)), 2**31 - 1)
        own = pool[rng.integers(0, pool.size, R)]
        vw = rng.integers(1, 4, R)
    nbud = ncw + vw[:, None] + rng.integers(0, 2, (R, D)) if dist else None
    if dist:
        nbud = np.minimum(nbud, 2**31 - 1)
    return nlab, nw, ncw, nbud, own, vw, W, nl


def micro_ragged_cases(torch, rng, dev):
    """Edge cases of the three kernels off the main path: ``lp_gain`` with
    -1 lanes mid-row, all-padding rows, +inf target weights, budget ties
    (integer weights make ``tgt_w + vw == budget`` common) and a graph
    row cut at ``max_degree``; ``bsr_spmm`` at F=1 and F=130, one slot a
    row, zero padded blocks and a block size below 128; ``embedding_bag``
    at BAG 1 and 3, repeated indices, D=1 and D=200."""
    from repro_torch.graphs import generators
    from repro_torch.kernels.bsr_spmm import bsr_spmm, ref as bsr_ref
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.lp_gain import lp_gain, ops as gain_ops
    from repro_torch.kernels.lp_gain import ref as gain_ref

    f32 = (lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.float32)).to(dev))
    cases = []
    for N, D, nl, budget, tile in ((1, 1, 3, 4, 1), (67, 5, 9, 6, 1),
                                   (96, 33, 20, 9, 32), (256, 128, 50, 8, 128),
                                   (512, 256, 40, 12, 256)):
        lab = rng.integers(0, nl, (N, D))
        lab[rng.random((N, D)) < 0.25] = -1          # -1 lanes mid-row
        lab[N - N // 6:] = -1                        # all-padding rows
        w = np.where(lab >= 0, rng.integers(1, 5, (N, D)), 0)
        cw = rng.integers(1, budget + 3, nl).astype(np.float32)
        cw[rng.random(nl) < 0.1] = np.inf            # +inf target weights
        tgt_w = np.where(lab >= 0, cw[np.maximum(lab, 0)], np.inf)
        own = rng.integers(0, nl, (N, 1))
        own[N - N // 6:] = -2
        vw = rng.integers(1, 3, (N, 1))
        args = (_i32(torch, lab, dev), f32(w), f32(tgt_w),
                _i32(torch, own, dev), f32(vw), f32([[budget]]))
        cases.append(("lp_gain", functools.partial(lp_gain.lp_gain_ell,
                                                   row_tile=tile),
                      gain_ref.lp_gain_ell_ref, args, {}))
    # the entry point's operands at both lane widths: a hub beyond 512
    # (D = 512 either way), a max degree of 139 (D = 160 against 256) and
    # a max degree near 20 (D = 32 against 128)
    for family, n, seed in (("ba", 20000, 5), ("ba", 1000, 2),
                            ("rgg2d", 5000, 3)):
        g = generators.make(family, n, 8.0, seed=seed)
        labels = rng.integers(0, 8, g.n)
        cw = np.bincount(labels, weights=g.vweights, minlength=8)
        for lanes in (32, 128):
            args = gain_ops.gain_operands(g, labels, cw,
                                          float(cw.max() - 20), 256, dev,
                                          lanes)
            cases.append(("lp_gain", lp_gain.lp_gain_ell,
                          gain_ref.lp_gain_ell_ref, args, {},
                          f"{family} {n} via gain_operands, lanes {lanes}"))
    for rb, nnz, bs, f in BSR_RAGGED:
        col, vals, x = bsr_random(rng, rb, nnz, bs, f)
        cases.append(("bsr_spmm", bsr_spmm.bsr_spmm, bsr_ref.bsr_spmm_ref,
                      (_i32(torch, col, dev), f32(vals), f32(x)),
                      dict(block_rows=rb, nnz_per_row=nnz)))
    for rb, nnz, bs, f, kind in ((4, 3, 128, 128, "scattered"),
                                 (3, 2, 128, 130, "scattered"),
                                 (5, 2, 64, 1, "scattered"),
                                 (4, 2, 128, 128, "zero_weights"),
                                 (3, 3, 99, 36, "zero_weights"),
                                 (3, 2, 128, 64, "beyond_split")):
        col, vals, x = bsr_non_finite(rng, rb, nnz, bs, f, kind)
        cases.append(("bsr_spmm", bsr_spmm.bsr_spmm, bsr_ref.bsr_spmm_ref,
                      (_i32(torch, col, dev), f32(vals), f32(x)),
                      dict(block_rows=rb, nnz_per_row=nnz),
                      f"non-finite: {kind}"))
    for B, bag, V, D in ((32, 1, 500, 64), (33, 3, 100, 200), (5, 3, 10, 1),
                         (9, 3, 4, 64), (1, 1, 1, 4), (1001, 1, 5000, 64),
                         (4099, 4, 5000, 64), (333, 17, 2000, 64),
                         (50, 2, 100, 8), (77, 3, 300, 132)):
        idx = rng.integers(0, V, (B, bag))
        idx[0] = idx[0, 0]                           # repeated indices
        table = rng.standard_normal((V, D))
        cases.append(("embedding_bag", eb.embedding_bag_1row,
                      eb_ref.embedding_bag_ref,
                      (_i32(torch, idx, dev), f32(table)), {}))
    return cases


# bsr_spmm's ragged shapes (block rows, slots a row, block size, F): F = 1
# and 130, one slot a row, a block size below 128
BSR_RAGGED = ((3, 2, 128, 1), (4, 3, 128, 130), (5, 1, 128, 64),
              (3, 2, 64, 96))


def bsr_random(rng, rb, nnz, bs, f):
    """(col, vals, x) of a bsr_spmm case: blocks 5% dense with values in
    [0, 1), about half the last slots of the rows padded (column block 0,
    all zero), X standard normal."""
    col = rng.integers(0, rb, rb * nnz)
    vals = rng.random((rb * nnz, bs, bs)) * \
        (rng.random((rb * nnz, bs, bs)) < 0.05)
    pad = (np.arange(rb * nnz) % nnz == nnz - 1) & (rng.random(rb * nnz)
                                                     < 0.5)
    col[pad] = 0                                     # zero padded blocks
    vals[pad] = 0.0
    x = rng.standard_normal((rb * bs, f))
    return col, vals, x


def bsr_non_finite(rng, rb, nnz, bs, f, kind):
    """(col, vals, x) of a bsr_spmm case whose values the kernel's TF32
    split cannot take. ``scattered``: +inf, -inf and NaN among the rows of
    X, one +inf in column block 0, which the padded all-zero slots
    multiply (0 x inf: NaN in the plain version). ``zero_weights``: a row
    of X all +inf that every block on its column block multiplies by
    zeros only, so it reaches Y as NaN and nowhere as inf. ``beyond_split``:
    finite values beyond 2^60 in X and A, and +inf in A."""
    col = rng.integers(0, rb, rb * nnz)
    vals = rng.random((rb * nnz, bs, bs)) * \
        (rng.random((rb * nnz, bs, bs)) < 0.05)
    pad = np.arange(rb * nnz) % nnz == nnz - 1
    col[pad] = 0
    vals[pad] = 0.0
    x = rng.standard_normal((rb * bs, f))
    if kind == "scattered":
        for v in (np.inf, -np.inf, np.nan):
            x[rng.integers(0, rb * bs, 2), rng.integers(0, f, 2)] = v
        x[rng.integers(0, bs), rng.integers(0, f)] = np.inf
    elif kind == "zero_weights":
        c, k = rb - 1, int(rng.integers(0, bs))
        col[0] = c
        x[c * bs + k] = np.inf
        vals[col == c, :, k] = 0.0
    else:
        x[rng.integers(0, rb * bs, 3), rng.integers(0, f, 3)] = 2.0**61
        x[rng.integers(0, rb * bs), rng.integers(0, f)] = -1e36
        vals[0, rng.integers(0, bs, 4), rng.integers(0, bs, 4)] = 3.0**40
        vals[1, rng.integers(0, bs), rng.integers(0, bs)] = np.inf
    return col, vals, x


def compare(name, got, want):
    """(max abs err, max rel err, share) of the kernel's outputs against
    the plain version's (0.0 iff bit-identical; equal infinities count as
    equal, a NaN on one side only as inf; the relative error is taken
    where the plain value is not 0; share: the largest error over its
    allowance atol + rtol |plain|, None where the kernel has no
    TOLERANCE); fails unless they are within the kernel's TOLERANCE, or
    equal where it has none."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    rtol, atol = TOLERANCE.get(name, (0.0, 0.0))
    err = rel = 0.0
    share = 0.0 if rtol or atol else None
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: output shape/dtype {tuple(a.shape)}/{a.dtype} vs "
              f"{tuple(b.shape)}/{b.dtype}")
        diff = a != b
        if a.is_floating_point():
            diff &= ~(a.isnan() & b.isnan())
        if not bool(diff.any()):
            continue
        da, db = a[diff].double(), b[diff].double()
        inf = float("inf")
        d = (da - db).abs().nan_to_num(nan=inf, posinf=inf)
        err = max(err, float(d.max()))
        nz = db != 0
        if bool(nz.any()):
            rel = max(rel, float((d[nz] / db[nz].abs())
                                 .nan_to_num(nan=inf, posinf=inf).max()))
        allow = atol + rtol * db.abs()
        check(bool((d <= allow).all()),
              f"{name}: kernel != plain beyond rtol {rtol} / atol {atol}, "
              f"max abs err {err}")
        if share is not None:
            share = max(share, float((d / allow).max()))
    return err, rel, share


def share_text(share) -> str:
    return "" if share is None else f", {share:.4f} of its allowance"


def bsr_spmm_seeds(torch, dev, seeds=range(1, 9)):
    """bsr_spmm's finite ragged shapes on more seeds: the largest error
    over its allowance (1e-5 + 1e-5 |plain|) of each shape across them."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm, ref as bsr_ref

    for rb, nnz, bs, f in BSR_RAGGED:
        worst = (0.0, 0.0)
        for seed in seeds:
            col, vals, x = bsr_random(np.random.default_rng(seed), rb, nnz,
                                      bs, f)
            args = [torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(dev)
                    for a, t in ((col, np.int32), (vals, np.float32),
                                 (x, np.float32))]
            kw = dict(block_rows=rb, nnz_per_row=nnz)
            got = bsr_spmm.bsr_spmm(*args, **kw)
            torch.cuda.synchronize()
            err, _, share = compare("bsr_spmm", got,
                                    bsr_ref.bsr_spmm_ref(*args, **kw))
            worst = max(worst, (share, err))
        say(f"  bsr_spmm {(rb * nnz, bs, bs)} F={f} on seeds "
            f"{seeds.start}..{seeds.stop - 1}: {tolerance_text('bsr_spmm')} "
            f"(worst {worst[0]:.4f} of its allowance, max abs err "
            f"{worst[1]})")


def tolerance_text(name) -> str:
    rtol, atol = TOLERANCE.get(name, (0.0, 0.0))
    return f"within rtol {rtol} / atol {atol}" if rtol or atol else "exact"


def phase_ragged(torch, dev):
    say("== phase 2: ragged kernel cases against the plain versions "
        "(tolerance 0; bsr_spmm rtol 1e-5 / atol 1e-5)")
    rng = np.random.default_rng(20260)
    for name, fn, plain, args, kw, *what in ragged_cases(torch, rng, dev):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        err, _, share = compare(name, got, want)
        shape = tuple(args[0].shape)
        timed = ""
        if what and name == "lp_move":   # phase-B chunks: candidates, time
            ms = cuda_ms(torch, lambda: fn(*args, **kw), 5)
            timed = (f"; {int(candidate_count(args, kw))} candidates, "
                     f"kernel {ms:.4f} ms")
        say(f"  {name} {shape}{''.join(' ' + w for w in what)}: "
            f"{tolerance_text(name)} (max abs err {err}"
            f"{share_text(share)}){timed}")
    bsr_spmm_seeds(torch, dev)


def candidate_count(args, kw):
    """The phase-B candidates of one ``lp_move`` call (rows that move to a
    target that would end above W), by the plain version's phase A and
    candidate rule on the call's inputs: a 0-d device tensor."""
    from repro_torch.kernels.lp_move import ref

    nlab, nw, ncw, own, vw, W, _, salt, num_labels = args
    nbud = kw.get("nbud")
    mv, tgt, light = ref.move_targets_ref(nlab, nw, ncw, own, vw, W, salt,
                                          nbud)
    return ref.candidates_ref(mv, tgt, own, vw, light, W,
                              num_labels)[0].sum()


# ---------------------------------------------------------------------------
# phases 3-4: the anchor and the main path
# ---------------------------------------------------------------------------

def run_partition(api, spec, k, kernel, *, config=None, preset="fast",
                  refine=None):
    req = api.PartitionRequest(graph=spec, k=k, epsilon=0.03,
                               preset=preset, config=config, kernel=kernel,
                               refine=refine)
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

    def wrap(self, module, attr, name, after=None):
        """Wrap ``module.attr``; ``after(args, kw)``, if given, runs after
        each call."""
        fn = getattr(module, attr)

        def wrapped(*args, **kw):
            size = args[0].numel()
            if size >= self.inputs.get(name, (-1,))[0]:
                cl = (lambda x: x.clone() if isinstance(
                    x, self.torch.Tensor) else x)
                self.inputs[name] = (size, fn, [cl(a) for a in args],
                                     {k: cl(v) for k, v in kw.items()})
            out = fn(*args, **kw)
            if after is not None:
                after(args, kw)
            return out

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def restore(self):
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


class HostTimers:
    """Wall seconds of the main path's host functions, summed per trace
    phase. It wraps the module attributes the core calls them through
    (the modules are not edited) and ``deep_mgp.trace_event``, whose call
    closes a phase: permute (coarsening's and refinement's),
    degree_bucket_order, build_move_chunks, lp.build_chunks, contract
    (np.unique, dedup_arcs and from_coo inside it) and dedup_arcs."""

    def __init__(self):
        self.current = {}
        self.phases = []
        self._undo = []

    def wrap(self, module, attr, label):
        fn = getattr(module, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.current[label] = self.current.get(label, 0.0) + \
                    time.perf_counter() - t0

        setattr(module, attr, timed)
        self._undo.append((module, attr, fn))

    def install(self):
        from repro_torch.core import (coarsening, contraction, deep_mgp, lp,
                                      refinement)
        from repro_torch.kernels.lp_move import ops as move_ops

        for module in (coarsening, refinement):
            self.wrap(module, "permute", "permute")
            self.wrap(module, "degree_bucket_order", "degree_bucket_order")
        self.wrap(move_ops, "build_move_chunks", "build_move_chunks")
        self.wrap(lp, "build_chunks", "lp.build_chunks")
        self.wrap(deep_mgp, "contract", "contract")
        self.wrap(contraction, "dedup_arcs", "dedup_arcs")
        trace_event = deep_mgp.trace_event

        def closing(trace, **record):
            trace_event(trace, **record)
            if "time_s" not in record:      # a refine-mode record
                return
            self.phases.append((record.get("phase"), record.get("level"),
                                record.get("n"), record.get("time_s"),
                                self.current))
            self.current = {}

        deep_mgp.trace_event = closing
        self._undo.append((deep_mgp, "trace_event", trace_event))

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo = []

    def report(self):
        for phase, level, n, secs, spent in self.phases:
            where = phase + ("" if level is None else f" level {level}")
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(spent.items()))
            say(f"  host s, {where} (n={n}, time_s {secs}): {parts or '-'}; "
                f"sum {sum(spent.values()) - spent.get('dedup_arcs', 0.0):.4f}"
                " (dedup_arcs counted inside contract)")


def phase_main_path(torch, api, build, candidates, seg_calls):
    say(f"== phase 4: main path rgg2d {FULL_N}, k=16, preset fast, fused")
    spec = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17)
    t0 = time.perf_counter()
    g = spec.materialize()
    say(f"  graph n={g.n} m={g.m} max_deg={int(g.degrees().max())} "
        f"({time.perf_counter() - t0:.2f} s, set-up)")
    torch.cuda.reset_peak_memory_stats()
    timers = HostTimers()
    timers.install()
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_partition(api, g, 16, "fused")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # the main path's run and no other
        wall = time.perf_counter() - t0
    finally:
        timers.restore()
    cut = int(res.metrics["cut"])
    say(f"  cut {cut} feasible {res.feasible} imbalance "
        f"{res.metrics.get('imbalance')} wall {wall:.3f} s peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for rec in res.trace:
        say("  trace " + json.dumps(rec, sort_keys=True))
    say(f"  launches {json.dumps(launches, sort_keys=True)}")
    counts = [int(c) for c in candidates]
    say(f"  lp_move phase-B candidates per call ({len(counts)} calls, the "
        f"plain version's rule on each call's inputs): max {max(counts)}, "
        f"more than one 1024-key tile in {sum(c > 1024 for c in counts)}; "
        f"{counts}")
    check(len(counts) == launches["lp_move"],
          "main path: a candidate count for every lp_move call")
    say(f"  seg_merge calls ({len(seg_calls)}): (records L, key bits per "
        f"half, radix passes) {seg_calls}")
    check(len(seg_calls) == launches["seg_merge"],
          "main path: an L and key width for every seg_merge call")
    timers.report()
    check(res.feasible and cut == FULL_CUT,
          f"main path: cut {cut}, feasible {res.feasible}; expected "
          f"{FULL_CUT}, feasible")
    for name in MAIN_PATH:
        check(launches[name] > 0, f"main path: {name} was never launched")
    return g, launches, res, wall


def skewed_rebalance(g, assignment, dev) -> dict:
    """Rebalance the finest level after moving 2000 vertices of block 1
    into block 0 (an overload a few pool rounds repair); returns the
    balancer's stats (rounds, time_s: its wall, host ELL build included)."""
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
    return stats


def finest_balancer(torch, build, g, assignment, dev):
    """The finest-level balancer (``skewed_rebalance``), run twice: as it
    is, for its rounds, launches, wall and peak device memory; then with
    the inputs of its last round's stages captured (``fused_round_scores``,
    ``bal_scores``, ``greedy_pick``; capturing clones them, so that run is
    not measured). Prints the first; returns (stats, capture)."""
    from repro_torch.kernels.bal_round import ops as bal_ops

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    st = skewed_rebalance(g, assignment, dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats = dict(rounds=st["rounds"], wall_s=st["time_s"],
                 launches=dict(build.LAUNCHES), peak_bytes=peak,
                 peak_above_bytes=peak - before)
    say(f"  finest-level balancer on a skewed partition: {st['rounds']} "
        f"rounds, wall {st['time_s']:.4f} s, peak device memory {peak} "
        f"bytes ({peak - before} above the {before} held before), launches "
        f"{json.dumps(stats['launches'], sort_keys=True)} (not the main "
        "path's)")
    cap = Capture(torch)
    for name in ("fused_round_scores", "bal_scores", "greedy_pick"):
        cap.wrap(bal_ops, name, name)
    try:
        skewed_rebalance(g, assignment, dev)
    finally:
        cap.restore()
    return stats, cap


def round_stages(torch, cap):
    """Device ms of the stages of the finest level's last round, on its
    captured inputs (CUDA events behind a sleep kernel): the score stage
    (``fused_round_scores``: the fallback table, ``bal_scores`` and any
    gathers around it), the pool (the stable descending sort of ``rel``
    and the pool's four gathers, as ``balance_round_fused`` does them) and
    ``greedy_pick``. The labels update and the overload check's read-back
    are not timed."""
    _, score_fn, sargs, skw = cap.inputs["fused_round_scores"]
    _, pick_fn, pargs, pkw = cap.inputs["greedy_pick"]
    rel, tgt = score_fn(*sargs, **skw)
    labels, vw, top_m = sargs[0], sargs[6], pargs[0].numel()

    def pool():
        vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
        return rel[vidx], tgt[vidx], labels[vidx], vw[vidx]

    out = dict(score_ms=device_ms(torch, [lambda: score_fn(*sargs, **skw)],
                                  10),
               pool_ms=device_ms(torch, [pool], 10),
               pick_ms=device_ms(torch, [lambda: pick_fn(*pargs, **pkw)],
                                 50))
    say(f"  finest-level round, device ms (CUDA events behind a sleep "
        f"kernel) at R={labels.numel()}, M={top_m}: score stage "
        f"{out['score_ms']:.4f}, pool sort {out['pool_ms']:.4f}, greedy_pick "
        f"{out['pick_ms']:.4f}; sum {sum(out.values()):.4f}")
    return out


def kernel_device(torch, name, fn, args, kw, where, expect=1):
    """One call's device launches (graph nodes; fails unless ``expect``,
    if given), device ms per call (CUDA events behind a sleep kernel) and
    the no-stream-wait check."""
    call = lambda: fn(*args, **kw)          # noqa: E731
    n = say_launches(torch, name, call, where)
    check(expect is None or n == expect,
          f"{name}: {n} device launches per call {where}; expected {expect}")
    ms = device_ms(torch, [call], 50 if name == "greedy_pick" else 20)
    say(f"  {name}: device time per call {ms:.4f} ms {where} (CUDA events "
        "behind a sleep kernel)")
    no_stream_wait(torch, name, call)
    return dict(device_launches=n, device_ms=ms)


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

    The ELL kernels (lp_move, bal_scores, lp_gain) need only the valid
    lanes of their (R, D) slabs: a slab counts sum(deg) lanes, not R * D
    (bal_scores: the valid lanes of ell_idx and ell_w, then its label
    table, per-row columns and K-entry block tables once, and its
    outputs). bsr_spmm needs 2 F operations per nonzero entry of its
    blocks (the zeros inside and the all-zero padded blocks need none,
    though they are read); embedding_bag reads each distinct table row
    once.

    greedy_pick is bound by the latency of its M steps, not by bytes or
    throughput: each step's test reads the weights of two blocks that
    the step before may have written, so the M steps form one chain of
    dependent loads, and the least time a load of the chain can take is
    one shared-memory load-to-use latency (CARD, measured in phase 1 by a
    pointer chase) at the card's maximum SM clock. Its "operations" time
    is M x that latency."""
    moved, ops = bound_parts(kind, args, kw, out)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    if kind == "greedy_pick":
        t_ops = args[0].numel() * CARD["smem_load_cycles"] / (
            CARD["sm_clock_mhz"] * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_parts(kind: str, args, kw, out):
    """(bytes moved, operations) of one call, as ``bound`` counts them. A
    stacked lp_move call counts each request's solo call: its valid
    lanes, columns, outputs and operations, summed."""
    if kind == "lp_move_stacked":
        S = args[0].shape[0]
        pick = (lambda x, s: x[s] if hasattr(x, "shape") else x)
        parts = [bound_parts("lp_move", [pick(a, s) for a in args],
                             {k: pick(v, s) for k, v in kw.items()
                              if v is not None},
                             tuple(o[s] for o in out)) for s in range(S)]
        return sum(m for m, _ in parts), sum(o for _, o in parts)
    tensors = [a for a in args if hasattr(a, "numel")]
    tensors += [v for v in kw.values() if hasattr(v, "numel")]
    outs = out if isinstance(out, tuple) else (out,)
    if kind in ("lp_move", "bal_scores", "lp_gain"):
        deg = (args[0] >= 0).sum(1).double()
        lanes = int(deg.sum())
        R, D = args[0].shape
        slabs = [t for t in tensors if tuple(t.shape) == (R, D)]
        cols = [t for t in tensors if tuple(t.shape) != (R, D)]
        moved = lanes * sum(t.element_size() for t in slabs) \
            + nbytes(*cols) + nbytes(*outs)
        # label-equality connectivity: deg^2 compare-adds per row,
        # plus ~16 ops per lane for admission and the tie chain
        ops = float((2 * deg * deg + 16 * deg).sum())
    elif kind == "seg_merge":
        moved = nbytes(*tensors) + nbytes(*outs)
        # a comparison sort needs L log2 L compares; flags and run
        # totals a few more per record
        L = args[0].numel()
        ops = float(L * max(1, (L - 1).bit_length()) + 4 * L)
    elif kind == "bsr_spmm":
        moved = nbytes(*tensors) + nbytes(*outs)
        ops = 2.0 * int((args[1] != 0).sum()) * args[2].shape[1]
    elif kind == "embedding_bag":
        idx, table = args
        rows = int(idx.unique().numel())
        moved = nbytes(idx) + rows * table.shape[1] * table.element_size() \
            + nbytes(*outs)
        ops = float(idx.numel() * table.shape[1])
    else:                                          # greedy_pick
        moved = nbytes(*tensors) + nbytes(*outs)
        ops = 0.0
    return moved, ops


def graph_launches(torch, call):
    """(launches, {kind: count}) of one call, counted exactly: the nodes
    of a CUDA graph captured around it (kernels, memsets, copies). The
    count needs no profiler, and a call that waited for the stream could
    not be captured."""
    import ctypes

    call()                          # builds, allocations, lazy set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        kind = {0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value,
                                                          f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    del graph
    torch.cuda.synchronize()
    return n.value, kinds


def device_ms(torch, calls, rounds):
    """Device milliseconds per call of ``calls``, taken in turn ``rounds``
    times: CUDA events around them, queued behind a sleep kernel that
    outlasts the host's launching, so that no host time is counted."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for call in calls:
            call()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    check(host_ms < ev[0].elapsed_time(ev[1]),
          f"the host took {host_ms:.1f} ms to launch, longer than the "
          "sleep that hides it")
    return ev[1].elapsed_time(ev[2]) / (rounds * len(calls))


def profiled(torch, call):
    """{kernel or memset name: device ms} of one call, as a torch.profiler
    window around it records them (after a warm-up call), or None if the
    window recorded no device activity. On the H100 machine (torch 2.11,
    CUDA 12.8) windows lose every device record now and then: the same
    sequence of calls recorded in one process and not in the next, and
    no window after torch.sparse's Triton BSR product (phase 6's library
    call) has recorded in any run, whatever TEARDOWN_CUPTI says. So the
    launch counts come from graph_launches and the device times from
    device_ms; the profiler adds only the per-kernel breakdown."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    return by_name or None


def say_launches(torch, name, call, where):
    """Print one call's device launches (graph nodes by kind) and its
    profiler breakdown; fail if the profiler, when it recorded, saw
    another count. Returns the count."""
    n, kinds = graph_launches(torch, call)
    say(f"  {name}: {n} device launches per call {where} "
        f"({', '.join(f'{c} {k}' for k, c in sorted(kinds.items()))})")
    check(n > 0, f"{name}: the captured graph holds no device launch")
    by_name = profiled(torch, call)
    if by_name is None:
        say("    the profiler window recorded no device activity")
        return n
    seen = sum(len(v) for v in by_name.values())
    check(seen == n, f"{name}: the profiler saw {seen} device launches, "
          f"the captured graph {n}")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        say(f"    {len(ms)} x {kname[:72]}: {sum(ms):.4f} ms on the device")
    return n


def no_stream_wait(torch, name, call):
    """Fail if ``call`` waits for the stream: it runs once under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    except RuntimeError as exc:
        raise SmokeFailure(f"{name}: the call waited for the stream: "
                           f"{exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"  {name}: no stream wait under set_sync_debug_mode('error')")


def lp_move_launches(torch, fn, args, kw):
    """Device launches of one lp_move call at the main path's chunk and at
    its first 67 rows (same num_labels): fail unless they are equal and
    at most 12, or if a call waits for the stream. Prints the call's
    device time."""
    rows = 67
    small = [a[:rows] if hasattr(a, "shape") else a for a in args]
    skw = {k: v[:rows] for k, v in kw.items() if v is not None}
    big = lambda: fn(*args, **kw)           # noqa: E731
    little = lambda: fn(*small, **skw)      # noqa: E731
    big_n = say_launches(torch, "lp_move", big,
                         f"at {args[0].shape[0]} rows")
    small_n = say_launches(torch, "lp_move", little,
                           f"at {rows} rows (num_labels {args[8]})")
    check(big_n == small_n <= 12,
          f"lp_move: {big_n} and {small_n} device launches per call; "
          "expected the same number, at most 12")
    say(f"  lp_move: device time per call {device_ms(torch, [big], 20):.4f} "
        "ms (CUDA events behind a sleep kernel)")
    no_stream_wait(torch, "lp_move", big)
    no_stream_wait(torch, "lp_move", little)


def synthetic_seg_merge(torch, g, dev):
    """The fine graph's 8,378,246 arcs merged in vertex pairs (``v //
    2``), unpadded, so runs of duplicates and self loops both occur. Its
    ids reach 2^19 - 1, so the key's halves are 20 bits wide."""
    src = (g.arc_tails() // 2).astype(np.int32)
    dst = (g.adjncy // 2).astype(np.int32)
    max_id = int(max(src.max(), dst.max()))
    return ([torch.from_numpy(x).to(dev) for x in
             (src, dst, g.eweights.astype(np.int32))], dict(max_id=max_id))


def seg_merge_launches_and_times(torch, fn, plain, args, kw, row):
    """seg_merge beyond its wrapper time, on the main path's largest call:
    device launches per call (graph nodes) at that L and at its first 5
    records with the same key width (must be equal, at most 12); no
    stream wait at either; device time behind a sleep kernel, L2-warm
    (one input again) and L2-cold (four input copies in turn, 4 x 12 B x
    L: 105 MB at level 0, beyond the 50 MB L2), for the kernel and the
    plain version alike; and, as a yardstick, one stable torch.sort of
    the same packed int64 keys with a gather of their int32 values ("sort
    only": no run flags, no totals). Adds them to the record row."""
    from repro_torch.kernels.seg_merge.ref import key_bits, key_halves

    L = args[0].numel()
    bits = key_bits(kw.get("max_id"))
    small = [a[:5] for a in args]
    big = lambda: fn(*args, **kw)           # noqa: E731
    little = lambda: fn(*small, **kw)       # noqa: E731
    big_n = say_launches(torch, "seg_merge", big, f"at L={L}")
    small_n = say_launches(torch, "seg_merge", little,
                           f"at L=5 (the same {bits}-bit key halves)")
    check(big_n == small_n <= 12,
          f"seg_merge: {big_n} and {small_n} device launches per call; "
          "expected the same number, at most 12")
    no_stream_wait(torch, "seg_merge", big)
    no_stream_wait(torch, "seg_merge", little)
    copies = [args] + [[a.clone() for a in args] for _ in range(3)]
    warm = device_ms(torch, [big], 20)
    cold = device_ms(torch, [functools.partial(fn, *c, **kw)
                             for c in copies], 5)
    plain_warm = device_ms(torch, [lambda: plain(*args, **kw)], 3)
    plain_cold = device_ms(torch, [functools.partial(plain, *c, **kw)
                                   for c in copies], 1)
    say(f"  seg_merge: device time per call (CUDA events behind a sleep "
        f"kernel) L2-warm {warm:.4f} ms, L2-cold {cold:.4f} ms; plain "
        f"version {plain_warm:.4f} / {plain_cold:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms")
    row.update(device_launches=big_n, device_ms=warm, device_ms_l2_cold=cold,
               plain_device_ms=plain_warm, plain_device_ms_l2_cold=plain_cold)
    if bits < 32:
        hi, lo = key_halves(args[0], args[1], bits)
        key = (hi << bits) | lo
        sort_ms = cuda_ms(torch, lambda: args[2][torch.sort(
            key, stable=True).indices], 20)
        say(f"  seg_merge yardstick, sort only: torch.sort(stable) of the "
            f"{2 * bits}-bit packed int64 keys + gather of the int32 values "
            f"{sort_ms:.4f} ms (not the whole function: no flags, no run "
            "totals)")
        row["sort_only_ms"] = sort_ms
    del copies


def phase_kernels(torch, build, capture, launches, g, assignment, dev):
    say("== phase 5: kernels against their plain versions at main-path "
        "shapes (tolerance 0: every output, rel included, bit-identical)")
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.kernels.seg_merge import ref as seg_ref
    from repro_torch.kernels.seg_merge import seg_merge as seg_mod

    plain = {"lp_move": lp_ref.lp_move_chunk_ref,
             "seg_merge": seg_ref.seg_merge_ref,
             "bal_scores": bal_ref.bal_scores_ell_ref,
             "greedy_pick": bal_ref.greedy_pick_ref}
    runs = [(name, *capture.inputs[name][1:]) for name in MAIN_PATH]
    # beyond the main path's own inputs (printed, not in the record):
    # seg_merge at the 2^20 graph's 8,378,246 arcs, the balancer at the
    # finest level
    sa, skw = synthetic_seg_merge(torch, g, dev)
    runs.append(("seg_merge", seg_mod.seg_merge, sa, skw))
    stats, finest = finest_balancer(torch, build, g, assignment, dev)
    runs += [(name, *finest.inputs[name][1:])
             for name in ("bal_scores", "greedy_pick")]
    rows = {}
    for name, fn, args, kw in runs:
        reps = 20 if name != "greedy_pick" else 200
        row = held_and_timed(torch, name, fn, plain[name], args, kw, reps,
                             launches[name])
        if name == "lp_move":
            lp_move_launches(torch, fn, args, kw)
        if name == "seg_merge" and name not in rows:
            seg_merge_launches_and_times(torch, fn, plain[name], args, kw,
                                         row)
        elif name == "seg_merge":
            say(f"  seg_merge at {args[0].numel()} records: device time per "
                f"call {device_ms(torch, [lambda: fn(*args, **kw)], 10):.4f}"
                " ms (L2-warm)")
        if name in ("bal_scores", "greedy_pick"):
            where = ("at the main path's call" if name not in rows
                     else "at the finest level")
            extra = kernel_device(torch, name, fn, args, kw, where)
            if name not in rows:
                row.update(extra)
        rows.setdefault(name, row)    # beyond the main path: printed only
    round_stages(torch, finest)
    del finest
    return [rows[name] for name in MAIN_PATH]


def in_turn(fn, arg_sets, kw):
    """One call of ``fn`` a call, on each of ``arg_sets`` in turn."""
    calls = itertools.cycle([functools.partial(fn, *a, **kw)
                             for a in arg_sets])
    return lambda: next(calls)()


def held_and_timed(torch, name, fn, plain, args, kw, reps, launches,
                   library=None, rotate=None):
    """Hold the kernel to its plain version on these inputs, time both
    (and the library call ``library(*args)``, if given) with CUDA events,
    and return the kernel's record row. ``rotate``: argument sets (the
    first ``args``) that the timed calls take in turn, for kernel, plain
    version and library alike."""
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel, share = compare(name, got, want)
    del want
    shape = [tuple(t.shape) for t in args if hasattr(t, "shape")]
    sets = rotate or [args]
    ms = cuda_ms(torch, in_turn(fn, sets, kw), reps)
    plain_ms = cuda_ms(torch, in_turn(plain, sets, kw), max(2, reps // 10))
    b_ms, b_by = bound(name, args, kw, got)
    lib_ms, lib_err = None, None
    if library is not None:
        lib_ms, lib_err = library_ms(torch, library, sets, got, reps)
    lib = ("n/a" if library is None else
           f"{lib_ms:.4f} ms" if lib_err is None else lib_err)
    say(f"  {name} {' '.join(map(str, shape))}: {tolerance_text(name)} "
        f"(max abs err {err}, max rel err {rel}{share_text(share)}); "
        f"kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library {lib}")
    src, replaces = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "shape": [list(t) for t in shape]}
    if share is not None:
        row["allowance_share"] = share
    if lib_err is not None:
        row["library_error"] = lib_err
    return row


def library_ms(torch, library, sets, got, reps):
    """(ms, None) of one PyTorch library call computing the kernel's
    function, ``library(*args)`` on each of ``sets`` in turn, or (None,
    its error) if the installed torch rejects it. The call is only a
    yardstick; its largest difference from the kernel's output (on the
    first set) is printed."""
    try:
        out = library(*sets[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    diff = float((out - got).abs().max())
    say(f"  library call: max abs difference from the kernel {diff}")
    return cuda_ms(torch, in_turn(library, sets, {}), reps), None


# ---------------------------------------------------------------------------
# phase 6: kernels off the main path, through their own entry points
# ---------------------------------------------------------------------------

GRID_SIDE = 1024           # spmm: grid2d 1024 x 1024, the mesh family
SPMM_F = 128               # d_hidden of the repo's dimenet config
EB_V, EB_D, EB_B = 1_000_000, 64, 65_536   # one dlrm-rm2 table, train batch
EB_SETS = 8                # index sets the timed embedding_bag calls rotate
DATA_SEED = 12


def drive(torch, build, name, call):
    """Run one entry-point path with the launch counts zeroed just before
    it and read just after it; fail unless ``name`` launched."""
    build.reset_launches()
    out = call()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    say(f"  launches {json.dumps(launches, sort_keys=True)}")
    check(launches[name] > 0, f"{name}: its entry point never launched it")
    return out, launches[name]


def edge_scan_gain(g, labels, cw, budget, k):
    """(gain, target, own_conn) by a scan over the arcs: the connection
    to each label, the best admissible one (the smallest label among the
    maximisers, -1 if none), as the JAX package's lp_gain test checks
    its kernel. Admission in f32, as the kernel tests it."""
    src = g.arc_tails().astype(np.int64)
    lab = labels.astype(np.int64)
    conn = np.bincount(src * k + lab[g.adjncy], weights=g.eweights,
                       minlength=g.n * k).reshape(g.n, k)
    own = conn[np.arange(g.n), lab]
    fits = (cw.astype(np.float32)[None, :]
            + g.vweights.astype(np.float32)[:, None]
            <= np.float32(budget)) & (conn > 0)
    fits[np.arange(g.n), lab] = False
    score = np.where(fits, conn, -1.0)
    best = score.max(1)
    target = np.where(best >= 0, score.argmax(1), -1)
    gain = best.astype(np.float32) - own.astype(np.float32)
    return gain, target.astype(np.int32), own.astype(np.float32)


def lp_gain_lane_widths(torch, g, labels, cw, budget, fn, args, dev):
    """The entry point's wall time and the kernel's time at 32 lanes (its
    default) and at the reference's 128, on the same assignment: the
    outputs must be the same bits. Each width's wall is timed three times,
    the widths in turn with the first alternating (128, 32, 32, 128, 128,
    32), and its median printed beside the three."""
    from repro_torch.kernels.lp_gain import ops as gain_ops

    walls = {128: [], 32: []}
    for lanes in (128, 32, 32, 128, 128, 32):
        t0 = time.perf_counter()
        gain_ops.lp_gain(g, labels, cw, budget, lanes=lanes)
        walls[lanes].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    wide = gain_ops.gain_operands(g, labels, cw, budget, 256, dev, lanes=128)
    narrow_out, wide_out = fn(*args), fn(*wide)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(narrow_out, wide_out)),
          "lp_gain: the 32-lane and 128-lane slabs give different outputs")
    ms = cuda_ms(torch, lambda: fn(*wide), 20)
    say(f"  lp_gain at 128 lanes (D={wide[0].shape[1]}, slabs "
        f"{nbytes(*wide[:3])} bytes): the same bits; kernel {ms:.4f} ms; "
        f"entry point wall, median of three, {med[128]:.3f} s "
        f"({', '.join(f'{t:.3f}' for t in walls[128])}) against "
        f"{med[32]:.3f} s at 32 lanes "
        f"({', '.join(f'{t:.3f}' for t in walls[32])})")
    del wide, narrow_out, wide_out


def bsr_spmm_launches_and_times(torch, args, kw):
    """bsr_spmm beyond its wrapper time, on phase 6's input: device
    launches per call (nodes of a captured CUDA graph of the kernel's
    launch path, which checks and reads back nothing), no stream wait,
    the device time (CUDA events behind a sleep kernel) and the share of
    16 x 8 A sub-tiles the kernel skips (X is finite here, so every
    all-zero one). Every call reads its 3.7 GB of inputs from HBM: they
    are 70 times the L2."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm as bsr_mod

    col, vals, xp = args
    rb, nnz = kw["block_rows"], kw["nnz_per_row"]
    bs = vals.shape[1]
    y = torch.empty(rb * bs, xp.shape[1], dtype=torch.float32,
                    device=xp.device)
    call = functools.partial(bsr_mod._launch, col, vals, xp, y, rb, nnz)
    n = say_launches(torch, "bsr_spmm", call, f"at {rb} block rows x {nnz} "
                     "slots")
    check(n == 1, f"bsr_spmm: {n} device launches per call; expected 1")
    no_stream_wait(torch, "bsr_spmm", call)
    share = None
    if bs == 128:
        nz = vals.view(-1, 8, 16, 16, 8).ne(0).any(4).any(2)
        share = 1.0 - float(nz.float().mean())
        del nz
    ms = device_ms(torch, [call], 5)
    say(f"  bsr_spmm: device time per call (CUDA events behind a sleep "
        f"kernel; L2-cold) {ms:.4f} ms; all-zero 16 x 8 A sub-tiles "
        f"skipped: {share if share is None else f'{100 * share:.4f}%'}")
    del y
    return dict(device_launches=n, device_ms_l2_cold=ms,
                zero_subtile_share=share)


def embedding_bag_row(torch, build, eb, eb_ops, eb_ref, dev):
    """embedding_bag through its entry point on one dlrm-rm2 table at the
    training batch, BAG 1 (the record's row) and 4 (printed). The timed
    calls take EB_SETS index sets in turn, whose gathered rows together
    (134 MB at BAG=1) exceed the H100's 50 MB L2, so that each call reads
    its rows from HBM as a training step does: the kernel, its plain
    version and F.embedding_bag alike. Device time is printed both so
    (cold) and for one set called again (warm, L2-resident)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(DATA_SEED)
    table = rng.standard_normal((EB_V, EB_D), dtype=np.float32)
    bags = {bag: rng.integers(0, EB_V, (EB_SETS, EB_B, bag)).astype(np.int32)
            for bag in (1, 4)}
    say(f"  embedding_bag: V={EB_V} D={EB_D} B={EB_B}, BAG 1 and 4, "
        f"{EB_SETS} index sets each ({time.perf_counter() - t0:.2f} s, "
        "set-up)")
    caps = {bag: Capture(torch) for bag in bags}

    def both_bags():
        outs = {}
        for bag, idx in bags.items():
            caps[bag].wrap(eb_ops, "_gather", "embedding_bag")
            try:
                outs[bag] = eb_ops.embedding_bag(idx[0], table)
            finally:
                caps[bag].restore()
        return outs

    outs, launches = drive(torch, build, "embedding_bag", both_bags)
    for bag, idx in bags.items():
        want = np.zeros((EB_B, EB_D), dtype=np.float32)
        for j in range(bag):
            want += table[idx[0][:, j]]
        check(np.array_equal(outs[bag], want),
              f"embedding_bag BAG={bag}: differs from the sequential sum")
        say(f"  embedding_bag BAG={bag} = sequential numpy sum (exact)")
    eb_rows = {}
    for bag in bags:
        # the entry point's launch path: indices checked on the host
        _, fn, args, kw = caps[bag].inputs["embedding_bag"]
        idx, tab = args
        sets = [(idx, tab)] + [(torch.from_numpy(x).to(dev), tab)
                               for x in bags[bag][1:]]
        gathered = EB_SETS * EB_B * bag * EB_D * 4 / 1e6
        say(f"  embedding_bag BAG={bag}: timed over the {EB_SETS} sets in "
            f"turn, {gathered:.1f} MB of gathered rows")
        eb_rows[bag] = held_and_timed(
            torch, "embedding_bag", fn, eb_ref.embedding_bag_ref, args, kw,
            200, launches, rotate=sets,
            library=lambda i, t: torch.nn.functional.embedding_bag(
                i, t, mode="sum"))
        checked_ms = cuda_ms(torch, in_turn(eb.embedding_bag_1row, sets, {}),
                             200)
        check_ms = cuda_ms(torch, in_turn(
            build.check_index_range, [("idx", i, EB_V) for i, _ in sets],
            {}), 200)
        say(f"  embedding_bag BAG={bag}: the checked wrapper "
            f"(embedding_bag_1row on device tensors) {checked_ms:.4f} ms, "
            f"of which its index range check {check_ms:.4f} ms")
        say_launches(torch, f"embedding_bag BAG={bag}",
                     lambda: fn(idx, tab), "on the launch path")
        cold = device_ms(torch, [functools.partial(fn, *a) for a in sets],
                         5)
        warm = device_ms(torch, [lambda: fn(idx, tab)], 40)
        say(f"  embedding_bag BAG={bag}: device time per call (CUDA events "
            f"behind a sleep kernel) L2-cold {cold:.4f} ms (the sets in "
            f"turn), L2-warm {warm:.4f} ms (one set again); bound "
            f"{eb_rows[bag]['bound_ms']:.4f} ms")
        eb_rows[bag]["device_ms_l2_cold"] = cold
        no_stream_wait(torch, f"embedding_bag BAG={bag}",
                       lambda: fn(idx, tab))
    return eb_rows[1]       # the config's bag size; BAG=4 printed


def phase_off_main(torch, build, g, assignment, dev):
    say("== phase 6: kernels off the main path, through their entry points "
        "on the default device")
    from repro_torch.core import metrics
    from repro_torch.graphs import generators
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops, ref as bsr_ref
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.lp_gain import ops as gain_ops
    from repro_torch.kernels.lp_gain import ref as gain_ref

    rows = []
    # lp_gain: the refinement gain at the finest level of phase 4's run
    k = 16
    labels = np.asarray(assignment)
    cw = np.bincount(labels, weights=g.vweights, minlength=k)
    budget = float(metrics.l_max(g.total_vweight, k, 0.03,
                                 int(g.vweights.max())))
    say(f"  lp_gain: rgg2d n={g.n}, phase 4's assignment (k={k}), "
        f"budget L_max={budget}")
    cap = Capture(torch)
    cap.wrap(gain_ops, "lp_gain_ell", "lp_gain")
    t0 = time.perf_counter()
    try:
        got, launches = drive(torch, build, "lp_gain",
                              lambda: gain_ops.lp_gain(g, labels, cw, budget))
    finally:
        cap.restore()
    say(f"  lp_gain entry point {time.perf_counter() - t0:.3f} s")
    want = edge_scan_gain(g, labels, cw, budget, k)
    for what, a, b in zip(("gain", "target", "own_conn"), got, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"lp_gain: {what} differs from the edge scan")
    say(f"  lp_gain = edge scan (exact); rows with an admissible target "
        f"{int((want[1] >= 0).sum())}")
    _, fn, args, kw = cap.inputs["lp_gain"]
    N, D = args[0].shape
    say(f"  lp_gain slabs: D={D} lanes, three {N} x {D} slabs of "
        f"{nbytes(*args[:3])} bytes together")
    rows.append(held_and_timed(torch, "lp_gain", fn, gain_ref.lp_gain_ell_ref,
                               args, {}, 20, launches))
    lp_gain_lane_widths(torch, g, labels, cw, budget, fn, args, dev)
    del cap, args, got, want
    torch.cuda.empty_cache()

    # bsr_spmm: GNN aggregation on the mesh family, F = dimenet's d_hidden
    t0 = time.perf_counter()
    gg = generators.grid2d(GRID_SIDE, GRID_SIDE)
    x = np.random.default_rng(DATA_SEED).standard_normal(
        (gg.n, SPMM_F), dtype=np.float32)
    say(f"  spmm: grid2d {GRID_SIDE}x{GRID_SIDE} n={gg.n} m={gg.m}, "
        f"F={SPMM_F} ({time.perf_counter() - t0:.2f} s, set-up)")
    cap = Capture(torch)
    cap.wrap(bsr_ops, "bsr_spmm", "bsr_spmm")
    t0 = time.perf_counter()
    try:
        y, launches = drive(torch, build, "bsr_spmm",
                            lambda: bsr_ops.spmm(gg, x))
    finally:
        cap.restore()
    say(f"  spmm entry point {time.perf_counter() - t0:.3f} s (host BSR "
        "build included)")
    yt = torch.from_numpy(y).to(dev).double()
    src = torch.from_numpy(gg.arc_tails().astype(np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(gg.adjncy, dtype=np.int64)).to(dev)
    w = torch.from_numpy(gg.eweights.astype(np.float64)).to(dev)
    xt = torch.from_numpy(x).to(dev).double()
    ref = torch.zeros_like(xt).index_add_(0, src, w[:, None] * xt[dst])
    d = (yt - ref).abs()
    check(bool((d <= 5e-4 + 5e-5 * ref.abs()).all()),
          f"spmm: differs from the COO sum beyond rtol 5e-5 / atol 5e-4 "
          f"(max abs {float(d.max())})")
    say(f"  spmm = COO sum in f64 within rtol 5e-5 / atol 5e-4 (max abs "
        f"{float(d.max())})")
    del yt, src, dst, w, xt, ref, d
    _, fn, args, kw = cap.inputs["bsr_spmm"]
    col, vals, xp = args
    bs = vals.shape[1]
    rb = kw["block_rows"]
    nnz = kw["nnz_per_row"]
    real = vals.flatten(1).ne(0).any(1)      # padded slots are all-zero
    say(f"  bsr: {rb} block rows x {nnz} slots, {int(real.sum())} nonzero "
        f"blocks, vals {nbytes(vals)} bytes; dense block products "
        f"{2.0 * int(real.sum()) * bs * bs * xp.shape[1]:.4g} flop "
        f"({2.0 * int(real.sum()) * bs * bs * xp.shape[1] / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms "
        "at the f32 rate)")

    extra = bsr_spmm_launches_and_times(torch, args, kw)

    @functools.lru_cache(maxsize=1)
    def bsr_matrix():       # built at the first library call
        crow = torch.zeros(rb + 1, dtype=torch.int64, device=dev)
        crow[1:] = real.view(rb, nnz).sum(1).cumsum(0)
        return torch.sparse_bsr_tensor(crow, col[real].long(), vals[real],
                                       size=(rb * bs, xp.shape[0]))

    rows.append(held_and_timed(torch, "bsr_spmm", fn, bsr_ref.bsr_spmm_ref,
                               args, kw, 20, launches,
                               library=lambda *_: bsr_matrix() @ xp))
    rows[-1].update(extra)
    bsr_matrix.cache_clear()
    del cap, args, col, vals, xp, real, y
    torch.cuda.empty_cache()
    rows.append(embedding_bag_row(torch, build, eb, eb_ops, eb_ref, dev))
    return rows



# ---------------------------------------------------------------------------
# phase 7: the unconstrained tier, the baselines, the CLI and a session
# ---------------------------------------------------------------------------

def strip_times(trace):
    return [{k: v for k, v in rec.items() if k != "time_s"}
            for rec in trace]


def unconstrained_trace():
    """The reference's trace of the unconstrained run, wall times apart."""
    names = {"coarsen": ("coarse_n", "W")}
    out = []
    for phase, level, n, m, a, b in UNCONSTRAINED_TRACE:
        rec = {"phase": phase}
        if level is not None:
            rec["level"] = level
        ka, kb = names.get(phase, ("blocks", "cut"))
        rec.update({"n": n, "m": m, ka: a, kb: b})
        out.append(rec)
        if phase != "coarsen":
            mode = {"phase": "refine-mode", "stage": phase,
                    "mode": "unconstrained"}
            if level is not None:
                mode["level"] = level
            mode.update(penalty=[0.0, 0.5],
                        repair_rounds=REPAIR_ROUNDS[(phase, level)])
            out.append(mode)
    return out


class NvccRuns:
    """Records the source of every nvcc process ``kernels._build`` starts
    while it is entered."""

    def __init__(self, build):
        self.build = build
        self.sources = []
        self._popen = build.subprocess.Popen

    def __enter__(self):
        popen = self._popen

        def counted(cmd, *args, **kw):
            self.sources.append(Path(cmd[-1]).stem)
            return popen(cmd, *args, **kw)

        self.build.subprocess.Popen = counted
        return self

    def __exit__(self, *exc):
        self.build.subprocess.Popen = self._popen


def session_first_loads(torch, api, build):
    """A threaded session whose requests load every kernel anew, from a
    fresh build directory: nvcc must run at most once a source, and every
    result must equal a solo run's and the reference's cut."""
    from repro_torch.core.deep_mgp import PartitionerConfig

    fresh = build.BUILD_DIR / f"session-{os.getpid()}"
    with build._LOCK:            # forget the libraries phase 1 loaded
        build.BUILD_DIR = fresh
        build._libs.clear()
    cfg = PartitionerConfig(contraction_limit=64)
    reqs = [api.PartitionRequest(graph=api.GraphSpec("rgg2d", 2000, 8.0,
                                                     seed=s),
                                 k=8, config=cfg) for s in SESSION_CUTS]
    reqs.append(dataclasses.replace(reqs[0], quality="best"))
    with NvccRuns(build) as nvcc:
        t0 = time.perf_counter()
        with api.PartitionSession(devices=1, max_workers=4) as sess:
            batch = sess.run_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"  session: {len(reqs)} requests on 4 threads, kernels loaded "
        f"from a fresh build directory, {wall:.3f} s (builds included); "
        f"nvcc runs {sorted(nvcc.sources)}")
    check(nvcc.sources and len(nvcc.sources) == len(set(nvcc.sources)),
          f"session: a library was built more than once: {nvcc.sources}")
    check(not list(fresh.glob("*.tmp")), "session: a build left a .tmp")
    solo = api.Partitioner().run_batch(reqs)
    want = [*SESSION_CUTS.values(), SESSION_BEST_CUT]
    for r, s, cut in zip(batch, solo, want):
        check(np.array_equal(r.assignment, s.assignment)
              and strip_times(r.trace) == strip_times(s.trace),
              f"session: {r.request.graph} differs from its solo run")
        check(r.feasible and r.cut == cut,
              f"session: cut {r.cut}, feasible {r.feasible}; the "
              f"reference gives {cut}, feasible")
    say(f"  session cuts {[r.cut for r in batch]} = solo runs = the "
        f"reference's; stats {sess.stats()}")


def phase_unconstrained(torch, api, build, g, lp_run, lp_wall, lp_launches):
    say(f"== phase 7: unconstrained tier at rgg2d {FULL_N}, the baselines, "
        "the CLI and a session")
    from repro_torch.core import balance, unconstrained
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.kernels.seg_merge import ops as seg_ops
    from repro_torch.kernels.seg_merge import ref as seg_ref

    session_first_loads(torch, api, build)

    capture = Capture(torch)
    for module, attr, name in ((lp_ops, "lp_move_chunk", "lp_move"),
                               (seg_ops, "seg_merge", "seg_merge"),
                               (bal_ops, "bal_scores", "bal_scores"),
                               (bal_ops, "greedy_pick", "greedy_pick")):
        capture.wrap(module, attr, name)
    timers = HostTimers()
    timers.install()
    # the unconstrained pass's own reorder, and every rebalance call's
    # (n, rounds, wall seconds): the afterburners and the rebalances
    # before each pass
    timers.wrap(unconstrained, "permute", "permute")
    timers.wrap(unconstrained, "degree_bucket_order", "degree_bucket_order")
    rebalances = []
    rebalance = balance.rebalance

    def timed_rebalance(g_, *args, **kw):
        kw["stats"] = stats = {} if kw.get("stats") is None else kw["stats"]
        t0 = time.perf_counter()
        out = rebalance(g_, *args, **kw)
        rebalances.append((g_.n, stats["rounds"], time.perf_counter() - t0))
        return out

    balance.rebalance = timed_rebalance
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_partition(api, g, 16, "fused", refine="unconstrained")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # this path's run and no other
        wall = time.perf_counter() - t0
    finally:
        balance.rebalance = rebalance
        timers.restore()
        capture.restore()
    say(f"  unconstrained: cut {res.cut} feasible {res.feasible} wall "
        f"{wall:.3f} s (lp, phase 4: cut {lp_run.cut}, wall {lp_wall:.3f} s)")
    say(f"  launches unconstrained {json.dumps(launches, sort_keys=True)}")
    say(f"  launches lp            {json.dumps(lp_launches, sort_keys=True)}")
    lp_times = {(r["phase"], r.get("level")): r["time_s"]
                for r in lp_run.trace if "time_s" in r}
    for rec in res.trace:
        if rec["phase"] == "refine-mode":
            say(f"    refine-mode {rec['stage']} level {rec.get('level')}: "
                f"penalty {rec['penalty']}, repair rounds "
                f"{rec['repair_rounds']}")
        else:
            key = (rec["phase"], rec.get("level"))
            say(f"  {key[0]} level {key[1]} n={rec['n']}: time_s "
                f"{rec['time_s']} (lp {lp_times.get(key)})")
    timers.report()
    ran = [(n, r, round(secs, 4)) for n, r, secs in rebalances if r]
    say(f"  rebalance calls {len(rebalances)}, "
        f"{sum(secs for *_, secs in rebalances):.4f} s in all; those that "
        f"ran rounds (n, rounds, s): {ran}")
    check(res.feasible and res.cut == UNCONSTRAINED_CUT,
          f"unconstrained: cut {res.cut}, feasible {res.feasible}; the "
          f"reference gives {UNCONSTRAINED_CUT}, feasible")
    check(strip_times(res.trace) == unconstrained_trace(),
          "unconstrained: the trace (refine-mode records included) differs "
          "from the reference's")
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"unconstrained path: {name} was never launched")
    plain = {"lp_move": lp_ref.lp_move_chunk_ref,
             "seg_merge": seg_ref.seg_merge_ref,
             "bal_scores": bal_ref.bal_scores_ell_ref,
             "greedy_pick": bal_ref.greedy_pick_ref}
    for name in MAIN_PATH:
        _, fn, args, kw = capture.inputs[name]
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        compare(name, got, plain[name](*args, **kw))
        ms = cuda_ms(torch, lambda: fn(*args, **kw), 20)
        shape = " ".join(str(tuple(t.shape)) for t in args
                         if hasattr(t, "shape"))
        say(f"  {name} at this path's largest call {shape}: bit-identical "
            f"to its plain version; kernel {ms:.4f} ms")
    del capture

    req = api.PartitionRequest(graph=g, k=16, epsilon=0.03, preset="fast",
                               kernel="fused", refine="unconstrained")
    build.reset_launches()
    results = api.Partitioner(backend="single").compare(
        req, list(BASELINE_CUTS))
    torch.cuda.synchronize()
    cmp_launches = dict(build.LAUNCHES)
    for r in results:
        say(f"  compare {r.backend}: cut {r.cut} feasible {r.feasible} "
            f"wall {r.time_s:.3f} s")
        check(r.feasible and r.cut == BASELINE_CUTS[r.backend],
              f"compare {r.backend}: cut {r.cut}, feasible {r.feasible}; "
              f"the reference gives {BASELINE_CUTS[r.backend]}, feasible")
    say(f"  deep MGP on the same request: lp cut {lp_run.cut} "
        f"({lp_wall:.3f} s), unconstrained {res.cut} ({wall:.3f} s); "
        "launches of the comparison "
        f"{json.dumps(cmp_launches, sort_keys=True)}")

    cmd = [sys.executable, "-m", "repro_torch.launch.partition", "--family",
           "rgg2d", "--n", "4000", "--k", "16", "--compare", "--trace"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                 PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0,
          f"CLI exit {out.returncode}: {out.stderr[-2000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    summaries = [x for x in lines if "backend" in x]
    cuts = {x["backend"]: x["cut"] for x in summaries}
    say(f"  CLI {' '.join(cmd[1:])}: exit 0, {len(lines)} lines, "
        f"{time.perf_counter() - t0:.2f} s; cuts {cuts}")
    check(len(summaries) == 3 and cuts == CLI_CUTS
          and all(x["feasible"] for x in summaries),
          f"CLI: summaries {summaries}; the reference CLI gives "
          f"{CLI_CUTS}, feasible")
    return {"main": lp_launches, "unconstrained": launches,
            "compare": cmp_launches}, res, wall


# ---------------------------------------------------------------------------
# phase 8: serving (the stacked level-0 clustering, a served burst, a
# served batch at the main path's size, the serve CLI)
# ---------------------------------------------------------------------------

SERVE_SEEDS = (0, 1, 2)       # 8a: request seeds of the stacked level 0
BURST_N = 1 << 16             # 8b: rgg2d n of the served burst


def stacked_level0(torch, api, build, g):
    """8a: the stacked level-0 clustering of three requests on the main
    path's graph (request seeds 0-2): fused against the composed stacked
    form on the card and three solo ``cluster(kernel="fused")`` calls,
    then one stacked ``lp_move`` call at the level-0 chunk shape against
    its plain version, timed beside the three solo calls of the same
    chunks. Returns the kernel's record row."""
    from repro_torch.core import coarsening
    from repro_torch.core.deep_mgp import level0_cluster_plan
    from repro_torch.kernels.lp_move import lp_move as lp_mod
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.serve import batching

    reqs = [api.PartitionRequest(graph=g, k=16, epsilon=0.03, preset="fast",
                                 seed=s) for s in SERVE_SEEDS]
    plans = [level0_cluster_plan(g, 16, r.resolve_config()) for r in reqs]
    capture = Capture(torch)
    capture.wrap(lp_ops, "lp_move_chunk_stacked", "lp_move_stacked")
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        fused = batching.stacked_level0_labels([g] * len(reqs), plans,
                                               kernel="fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        capture.restore()
    calls = plans[0]["num_iterations"] * plans[0]["num_chunks"]
    say(f"  8a stacked level 0, S={len(reqs)} (request seeds "
        f"{list(SERVE_SEEDS)}, W {[p['W'] for p in plans]}): {wall:.3f} s, "
        f"lp_move_stacked {launches['lp_move_stacked']} calls, lp_move "
        f"{launches['lp_move']}")
    check(launches["lp_move_stacked"] == calls and launches["lp_move"] == 0,
          f"8a: {launches['lp_move_stacked']} stacked and "
          f"{launches['lp_move']} solo lp_move calls; expected {calls} and 0")
    t0 = time.perf_counter()
    composed = batching.stacked_level0_labels([g] * len(reqs), plans,
                                              kernel="composed")
    composed_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [coarsening.cluster(g, p["W"], num_iterations=p["num_iterations"],
                               num_chunks=p["num_chunks"], seed=p["seed"],
                               kernel="fused") for p in plans]
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    for s, (a, b, c) in enumerate(zip(fused, composed, solo)):
        check(np.array_equal(a, b) and np.array_equal(a, c),
              f"8a: request {s}'s stacked labels differ from the composed "
              "stacked form or its solo cluster call")
    say(f"  8a labels bit-identical to the composed stacked form "
        f"({composed_wall:.3f} s) and to 3 solo cluster(kernel='fused') "
        f"calls ({solo_wall:.3f} s)")
    _, fn, args, kw = capture.inputs["lp_move_stacked"]
    del capture
    S, R, D = args[0].shape
    check((S, R, D) == (3, 262144, 32),
          f"8a: the stacked call's shape {(S, R, D)}; expected the level-0 "
          "chunk's (3, 262144, 32)")
    # the free-memory guard of _stacked_fused against the peak it guards,
    # on a run without the capture's copies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    again = batching.stacked_level0_labels([g] * len(reqs), plans,
                                           kernel="fused")
    peak = torch.cuda.max_memory_allocated() - held
    need = lp_ops.stacked_bytes(S, plans[0]["num_chunks"], R, D, args[-1])
    check(all(np.array_equal(a, b) for a, b in zip(again, fused)),
          "8a: a second stacked level 0 differs from the first")
    check(0 < peak <= need,
          f"8a: the stacked level 0 peaked at {peak} device bytes; its "
          f"free-memory guard reckons {need}")
    say(f"  8a device memory: peak {peak} bytes over the stacked level 0, "
        f"guard (stacked_bytes) {need} bytes")
    row = held_and_timed(torch, "lp_move_stacked", fn,
                         lp_ref.lp_move_chunk_stacked_ref, args, kw, 20,
                         launches["lp_move_stacked"])
    call = (lambda: fn(*args, **kw))            # noqa: E731
    n_stacked = say_launches(torch, "lp_move_stacked", call,
                             f"at S={S} x {R} rows")
    nlab, nw, ncw, own, vw, W, v0, salt, num_labels = args
    Ws, v0s, salts = (x.tolist() for x in (W, v0, salt))
    solo_calls = [functools.partial(
        lp_mod.lp_move_chunk, nlab[s], nw[s], ncw[s], own[s], vw[s], Ws[s],
        v0s[s], salts[s] & 0xFFFFFFFF, num_labels) for s in range(S)]
    n_solo = say_launches(torch, "lp_move", solo_calls[0],
                          f"at {R} rows (one request's chunk)")
    check(n_stacked == n_solo <= 12,
          f"8a: {n_stacked} device launches a stacked call, {n_solo} a solo "
          "one; expected the same number, at most 12")
    dev_ms = device_ms(torch, [call], 20)
    solo_ms = cuda_ms(torch, lambda: [c() for c in solo_calls], 20)
    solo_dev = device_ms(torch, solo_calls, 20) * S
    no_stream_wait(torch, "lp_move_stacked", call)
    for s, c in enumerate(solo_calls):
        got = c()
        check(all(torch.equal(a, b[s]) for a, b in zip(got, fn(*args,
                                                                **kw))),
              f"8a: request {s}'s solo lp_move call differs from its row "
              "of the stacked call")
    say(f"  lp_move_stacked: device time per call {dev_ms:.4f} ms (CUDA "
        f"events behind a sleep kernel); the {S} solo calls of the same "
        f"chunks {solo_ms:.4f} ms back to back (wrapper), {solo_dev:.4f} ms "
        f"of device time; stacked {row['ms']:.4f} ms; bound "
        f"{row['bound_ms']:.7f} ms ({row['bound_by']})")
    row.update(device_launches=n_stacked, device_ms=dev_ms,
               solo_calls_ms=solo_ms, solo_calls_device_ms=solo_dev,
               stack=S)
    return row


class HintTimes:
    """Wall seconds of every stacked level-0 computation of a batch
    (``serve.batching._level0_hints``, the module attribute wrapped while
    entered): (distinct requests, stacked ones, seconds)."""

    def __init__(self):
        from repro_torch.serve import batching
        self.batching = batching
        self.calls = []

    def __enter__(self):
        hints = self._hints = self.batching._level0_hints

        def timed(session, requests, stack):
            t0 = time.perf_counter()
            out = hints(session, requests, stack)
            self.calls.append((len(requests),
                               sum(h is not None for h in out),
                               round(time.perf_counter() - t0, 4)))
            return out

        self.batching._level0_hints = timed
        return self

    def __exit__(self, *exc):
        self.batching._level0_hints = self._hints


def phase_seconds(results):
    """Sum of the trace's time_s per phase over ``results``."""
    out = {}
    for r in results:
        for rec in r.trace:
            if "time_s" in rec:
                out[rec["phase"]] = out.get(rec["phase"], 0.0) + \
                    rec["time_s"]
    return {k: round(v, 3) for k, v in out.items()}


def burst(torch, build, srv_cls, reqs, best, meshes):
    """The burst through ``srv_cls(meshes=meshes)``: (results, stats,
    wall, process CPU seconds, launches, stacked level-0 times)."""
    build.reset_launches()
    t0, c0 = time.perf_counter(), time.process_time()
    with HintTimes() as hints, srv_cls(meshes=meshes, batch_max=8,
                                       batch_window_ms=50.0) as srv:
        futs = [srv.submit(r, priority=i % 2) for i, r in enumerate(reqs)]
        futs.append(srv.submit(best, deadline_s=600))
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        stats = srv.stats()
    return (results, stats, time.perf_counter() - t0,
            time.process_time() - c0, dict(build.LAUNCHES), hints.calls)


def served_burst(torch, api, build):
    """8b: a burst of 13 requests through a one-worker and then a
    two-worker PartitionServer on the card, each result against a solo
    run; one ``quality="best"`` request with a deadline is downgraded to
    ``fast`` at admission. No attempt may fail (a failed stacked call
    would be retried solo), and the launch counts are pinned: level 0 of
    every stacked request runs in the stacked kernel, the rest of each
    distinct run in solo ``lp_move`` calls. Returns the two-worker
    burst's launch counts."""
    from repro_torch.core.deep_mgp import level0_cluster_plan
    from repro_torch.serve import PartitionServer

    spec = api.GraphSpec("rgg2d", BURST_N, 8.0, seed=17)
    base = {s: api.PartitionRequest(graph=spec, k=16, preset="fast", seed=s)
            for s in range(6)}
    reqs = [base[s] for s in range(6)] * 2
    best = dataclasses.replace(base[0], quality="best")
    solo, solo_lp, solo_wall = {}, {}, 0.0
    for s, r in base.items():
        build.reset_launches()
        t0 = time.perf_counter()
        solo[s] = api.Partitioner().run(r)
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo_lp[s] = build.LAUNCHES["lp_move"]
    plan = level0_cluster_plan(spec.materialize(), 16,
                               base[0].resolve_config())
    level0 = plan["num_iterations"] * plan["num_chunks"]
    keys = ("completed", "batches", "coalesced", "batch_size_max",
            "latency_p50_s", "latency_p99_s", "queue_wait_p99_s",
            "downgraded", "retried", "per_worker_served")
    for meshes in (1, 2):
        results, stats, wall, cpu, launches, hints = burst(
            torch, build, PartitionServer, reqs, best, meshes)
        tag = f"8b ({meshes} worker{'s' * (meshes > 1)})"
        for r, req in zip(results, reqs + [base[0]]):
            check(r.ok, f"{tag}: a served result is not ok: {r.error} "
                  f"{r.detail}")
            check(r.attempts == 1, f"{tag}: a request took {r.attempts} "
                  "attempts")
            check(np.array_equal(r.result.assignment,
                                 solo[req.seed].assignment),
                  f"{tag}: the served result of seed {req.seed} differs "
                  "from its solo run")
        check(results[-1].result.request.quality == "fast"
              and stats["downgraded"] == 1,
              f"{tag}: the deadline-bearing quality='best' request was not "
              "downgraded to fast")
        check(stats["retried"] == 0, f"{tag}: {stats['retried']} retries")
        served = list({id(r.result): r.result for r in results}.values())
        stacked = [c for c in hints if c[1]]
        want_stacked = level0 * len(stacked)
        want_lp = sum(solo_lp[r.request.seed] for r in served) \
            - level0 * sum(c[1] for c in stacked)
        check(stacked and launches["lp_move_stacked"] == want_stacked
              and launches["lp_move"] == want_lp,
              f"{tag}: lp_move_stacked {launches['lp_move_stacked']}, "
              f"lp_move {launches['lp_move']}; expected {want_stacked} and "
              f"{want_lp} (stacked level 0s {hints})")
        say(f"  {tag} served burst: rgg2d n={BURST_N}, k=16, fast, seeds "
            f"0-5 twice + seed 0 'best' (deadline 600 s): all ok in one "
            f"attempt, bit-identical to solo runs; wall {wall:.3f} s, "
            f"process CPU {cpu:.3f} s, throughput "
            f"{len(results) / wall:.3f} requests/s; stats "
            f"{json.dumps({k: stats[k] for k in keys})}")
        say(f"  {tag} launches {json.dumps(launches, sort_keys=True)}; "
            f"stacked level 0s (distinct, stacked, s) {hints}; trace "
            f"seconds by phase, the {len(served)} distinct served runs "
            f"{json.dumps(phase_seconds(served))}")
    say(f"  8b the 6 distinct solo runs: {solo_wall:.3f} s, lp_move "
        f"{json.dumps(solo_lp)}, trace seconds by phase "
        f"{json.dumps(phase_seconds(solo.values()))}")
    return launches


def served_main_size(torch, api, build, g, lp_run, lp_wall, un_run,
                     un_wall, solo_launches):
    """8c: ``submit_many`` of four requests on the main path's graph
    through a ``stack="auto"`` session on the card: seed 0 fast and best
    must give phase 4's and phase 7's assignments (the reference's cuts),
    seed 1 its solo run's, and the duplicate shares seed 0's run. Returns
    the batch's launch counts. ``solo_launches``: phases 4's and 7's."""
    from repro_torch.core.deep_mgp import level0_cluster_plan

    def req(seed, quality):
        return api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                    preset="fast", seed=seed,
                                    quality=quality)

    reqs = [req(0, "fast"), req(1, "fast"), req(0, "best"), req(0, "fast")]
    build.reset_launches()
    t0 = time.perf_counter()
    solo1 = api.Partitioner().run(reqs[1])
    torch.cuda.synchronize()
    solo1_wall = time.perf_counter() - t0
    solo1_launches = dict(build.LAUNCHES)
    build.reset_launches()
    t0 = time.perf_counter()
    with HintTimes() as hints, api.PartitionSession(stack="auto") as sess:
        out = sess.submit_many(reqs).result()
        torch.cuda.synchronize()
        served = sess.stats()["served"]
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for r, want, what in ((out[0], lp_run, "phase 4's"),
                          (out[2], un_run, "phase 7's"),
                          (out[1], solo1, "its solo run's")):
        check(np.array_equal(r.assignment, want.assignment),
              f"8c: seed {r.request.seed} {r.request.quality} differs from "
              f"{what} assignment")
    check(out[0].cut == FULL_CUT and out[2].cut == UNCONSTRAINED_CUT
          and all(r.feasible for r in out),
          f"8c: cuts {[r.cut for r in out]}; expected {FULL_CUT} (fast) "
          f"and {UNCONSTRAINED_CUT} (best), feasible")
    check(out[3] is out[0] and served == 3,
          f"8c: the duplicate did not share seed 0's run ({served} runs)")
    plan = level0_cluster_plan(g, 16, reqs[0].resolve_config())
    level0 = plan["num_iterations"] * plan["num_chunks"]
    want_solo = sum(c["lp_move"] for c in (*solo_launches, solo1_launches)) \
        - 3 * level0
    check(launches["lp_move_stacked"] == level0
          and launches["lp_move"] == want_solo,
          f"8c: lp_move_stacked {launches['lp_move_stacked']}, lp_move "
          f"{launches['lp_move']}; expected {level0} and {want_solo}: the "
          "three distinct requests' level 0 stacked, the rest solo")
    say(f"  8c submit_many (seed 0 fast, seed 1 fast, seed 0 best, seed 0 "
        f"fast again) at rgg2d {FULL_N}: cuts {[r.cut for r in out]}, "
        f"{served} runs; batch wall {wall:.3f} s against the solo walls "
        f"{lp_wall:.3f} + {solo1_wall:.3f} + {un_wall:.3f} = "
        f"{lp_wall + solo1_wall + un_wall:.3f} s (phases 4, 8c, 7)")
    say(f"  8c launches, batch {json.dumps(launches, sort_keys=True)}; solo "
        f"seed 1 {json.dumps(solo1_launches, sort_keys=True)}")
    say(f"  8c stacked level 0 (distinct, stacked, s) {hints.calls}; trace "
        f"seconds by phase, the batch's 3 runs "
        f"{json.dumps(phase_seconds(out[:3]))}, the solo runs "
        f"{json.dumps(phase_seconds([lp_run, solo1, un_run]))}")
    return launches


def phase_serving(torch, api, build, g, lp_run, lp_wall, un_run, un_wall,
                  by_path):
    say("== phase 8: serving: stacked level 0, a served burst, a served "
        "batch at the main path's size, the serve CLI")
    row = stacked_level0(torch, api, build, g)
    burst = served_burst(torch, api, build)
    main = served_main_size(torch, api, build, g, lp_run, lp_wall, un_run,
                            un_wall, (by_path["main"],
                                      by_path["unconstrained"]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--meshes", "2",
           "--requests", "12", "--n", "4000", "--k", "8", "--verify"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                 PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0,
          f"serve CLI exit {out.returncode}: {out.stderr[-2000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    check({"verify": "bit-identical"} in lines
          and sum(1 for x in lines if x.get("ok")) == 12,
          f"serve CLI: {out.stdout[-2000:]}")
    stats = lines[-1]["stats"]
    say(f"  8d CLI {' '.join(cmd[1:])}: exit 0, 12 ok, verify "
        f"bit-identical, {time.perf_counter() - t0:.2f} s; batches "
        f"{stats['batches']}, coalesced {stats['coalesced']}, wall "
        f"{stats['wall_s']} s")
    row["launches"] = main["lp_move_stacked"]
    return row, {"serve_burst": burst, "serve_main": main}



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
    from repro_torch.kernels.seg_merge.ref import key_bits, key_passes

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in the JAX package")
    dev = torch.device("cuda", 0)
    # the plain versions' f32 products (bsr_spmm's einsum) in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are still on")
    t_all = time.perf_counter()
    smi = phase_environment(torch, build)
    phase_ragged(torch, dev)
    phase_anchor(torch, api, deep_mgp)
    capture = Capture(torch)
    candidates = []
    capture.wrap(lp_ops, "lp_move_chunk", "lp_move",
                 after=lambda a, kw: candidates.append(
                     candidate_count(a, kw)))
    seg_calls = []
    capture.wrap(seg_ops, "seg_merge", "seg_merge",
                 after=lambda a, kw: seg_calls.append(
                     (a[0].numel(), key_bits(kw.get("max_id")),
                      key_passes(key_bits(kw.get("max_id"))))))
    capture.wrap(bal_ops, "bal_scores", "bal_scores")
    capture.wrap(bal_ops, "greedy_pick", "greedy_pick")
    try:
        g, launches, lp_run, lp_wall = phase_main_path(
            torch, api, build, candidates, seg_calls)
    finally:
        capture.restore()
    assignment = lp_run.assignment
    kernels = phase_kernels(torch, build, capture, launches, g, assignment,
                            dev)
    kernels += phase_off_main(torch, build, g, assignment, dev)
    by_path, un_run, un_wall = phase_unconstrained(
        torch, api, build, g, lp_run, lp_wall, launches)
    stacked_row, serve_paths = phase_serving(torch, api, build, g, lp_run,
                                             lp_wall, un_run, un_wall,
                                             by_path)
    by_path.update(serve_paths)
    kernels.insert(1, stacked_row)
    for row in kernels:
        if row["name"] in MAIN_PATH + ("lp_move_stacked",):
            row["launches_by_path"] = {p: c[row["name"]]
                                       for p, c in by_path.items()}
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
